"""The port's launcher and its guards: ``launch.quantize --smoke --device cpu``
runs end to end; asking for CUDA where there is none raises instead of
falling back to the CPU; the port and chip_smoke.py import neither jax nor
the reference package; every kernel source has its wrapper.
"""
import ast
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core.bpv import VQConfig
from repro_torch.core.gptvq import gptvq_quantize_matrix
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import get_recipe
from repro_torch.data.calibration import calibration_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.launch import quantize as launch_quantize
from repro_torch.models import model_zoo

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(repro_torch.__file__).resolve().parent

SMOKE_ARGS = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
              "--sequences", "8", "--seq-len", "32", "--em-iters", "4",
              "--update-iters", "2"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_launcher_smoke_on_cpu(capsys):
    rep, ppl_fp, ppl_vq = launch_quantize.main(SMOKE_ARGS)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "block 2/2 [layer1] done" in out
    assert "| ppl fp=" in out and "achieved 2.250 bpv" in out
    assert "stages:" in out
    assert math.isfinite(ppl_fp) and math.isfinite(ppl_vq)
    assert rep.achieved_bpv == 2.25
    assert len(rep.per_target) == 14
    assert set(rep.stage_seconds) == {"hessian_capture", "em_init",
                                      "column_sweep", "codebook_update",
                                      "advance"}


def test_launcher_out_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="checkpointer"):
        launch_quantize.main(SMOKE_ARGS + ["--out", "ckpt"])


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        model_zoo.build(cfg).init_params(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration_tokens(cfg.vocab_size, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"layers": []}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_quantize.main(["--arch", "llama2-7b", "--smoke"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_and_chip_smoke_import_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f): sorted(n for n in _imports(f) if _forbidden(n))
           for f in files}
    assert not {f: n for f, n in bad.items() if n}
    # and at run time: every module imports with jax and repro blocked
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30


def test_every_kernel_source_has_a_wrapper():
    cu = sorted(p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu"))
    assert cu == sorted(build.SOURCES)
    for name in build.SOURCES:
        assert (PORT / "kernels" / f"{name}.py").exists()
        text = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        # the header names the TPU kernel it replaces and its bound
        assert "Replaces: src/repro/kernels/" in text
        assert "What bounds it on the H100" in text


@pytest.mark.parametrize("module,name", [
    ("core.hessian", "accumulate_diag"), ("core.hessian", "accumulate_sharded"),
    ("core.codebook", "kmeanspp_init"),
    ("core.codebook_compress", "svd_compress"),
    ("core.recipe", "IntQuant"), ("core.recipe", "allocate_budget"),
    ("models.attention", "init_cache"), ("models.transformer", "init_cache")])
def test_left_out_functions_name_their_roadmap_entry(module, name):
    import importlib

    fn = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        fn()


def test_left_out_options_raise():
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=1)
    model = model_zoo.build(cfg)
    with pytest.raises(NotImplementedError, match="Budgets and solvers"):
        quantize_model(model, {}, torch.zeros((1, 4), dtype=torch.long),
                       budget_bpv=2.5)
    with pytest.raises(NotImplementedError, match="Budgets and solvers"):
        gptvq_quantize_matrix(torch.zeros(4, 4), torch.eye(4), VQConfig(),
                              solver="babai")
    with pytest.raises(NotImplementedError, match="five families"):
        model_zoo.build(SMOKE["qwen3-moe-30b-a3b"])
    with pytest.raises(NotImplementedError, match="JSON"):
        get_recipe("mixed.json")
