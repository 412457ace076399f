"""Model assemblies of the port (all six families)."""
