"""Model assemblies of the port (dense family in this slice)."""
