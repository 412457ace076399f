"""The command exits with a code other than 0 and prints no result where
it cannot measure: without a CUDA card, and in a directory that holds only
``BENCHMARK.json`` and the benchmark's files (no program beside them)."""
import shutil
import subprocess
import sys

import pytest
import torch

from tiny import REPO

ARGS = ["--workload", "qwen2-72b.chat", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "is_available() is False" in p.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no src/repro_torch" in p.stderr
