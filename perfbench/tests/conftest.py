"""Puts the benchmark and the port on ``sys.path`` for these tests; they
are run from the repository root as ``python -m pytest -q
perfbench/tests`` (the repository's own suite does not collect them)."""
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent)]
import tiny  # noqa: E402,F401
