"""GPTVQ core of the port: Hessians, codebooks, the column sweep, packing."""
