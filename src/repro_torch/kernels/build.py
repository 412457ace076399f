"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (``csrc/*.cuh`` are the
headers they share). At first use it is compiled with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into ``build/repro_torch/lib<name>.so`` at
the root of the checkout (``build/`` is git-ignored) and loaded with
``ctypes``. ``build_all`` starts one ``nvcc``
per source, all at once, so the build takes as long as the slowest file.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("vq_assign", "vq_dequant_matmul", "paged_attention",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of each source's launch function: (name, argtypes)
_ENTRY = {
    "vq_assign": ("vq_assign_launch",
                  [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _I, _P]),
    # one int64 array of every argument (csrc/vq_dequant_matmul.cu)
    "vq_dequant_matmul": ("vq_dequant_matmul_launch", [_P]),
    "paged_attention": ("paged_attention_launch",
                        [_P, _I] + [_P] * 9 + [_I] * 9 + [_P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _I, _P, _P, _I, _P] + [_I] * 9 + [_P]),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = lib_path(name)
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return (not lib.exists()
            or lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs))


def build_all(names=SOURCES, force: bool = False) -> dict[str, dict]:
    """Compile every stale (or, with ``force``, every) source in parallel.

    Returns {name: {"seconds": wall seconds, "ptxas": compiler report}};
    raises RuntimeError with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    exe = nvcc() if todo else None
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = {}
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        report[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        fn_name, argtypes = _ENTRY[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def current_stream(device) -> int:
    """The address of ``device``'s current CUDA stream, for a launch, from
    PyTorch's raw accessor (as Triton's launcher reads it):
    ``torch.cuda.current_stream`` builds a Stream object, several
    microseconds of host time on every call."""
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def check(rc: int, what: str) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
