"""Paged continuous-batching serving (port of ``repro/serve``)."""
