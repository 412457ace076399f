"""Model assemblies of the port (the dense and moe families)."""
