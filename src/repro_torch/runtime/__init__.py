"""Host-side runtime supervision of the port (training loop)."""
