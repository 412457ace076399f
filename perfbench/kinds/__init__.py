"""General runners, one a traffic kind: ``<kind>.run(cell, seed=,
seconds=, trace=, device=, t_start=)`` returns the run's record."""
