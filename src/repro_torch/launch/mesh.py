"""Device meshes (port of ``repro/launch/mesh.py``): ``torch.distributed``
``DeviceMesh``es with the reference's axis names, ``("data", "model")``.

Defined as functions, so importing this module starts no process group.
A mesh needs the default process group: the mesh functions start it
(``init_world``) on the backend of ``world_backend``'s rule (NCCL when
each rank on the host has a card of its own, gloo when ranks share one
card or run on the CPU), from ``torchrun``'s environment or, for a world
of one, from an in-process store.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

AXES = ("data", "model")

HARDWARE = {
    # one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), the figures
    # PERF.md's bounds use; they assume the card's full 700 W power limit,
    # and a card set below it runs slower under load
    "card": "NVIDIA H100 80GB HBM3, 700 W power limit",
    "peak_flops_bf16": 989e12,   # FLOP/s, tensor cores
    "hbm_bw": 3.35e12,           # B/s
    "hbm_bytes": 80 * 10**9,     # 80 GB
}


def world_backend(device_type: str, world_size: int) -> str:
    """The backend for ranks on ``device_type``: ``nccl`` when each rank
    on this host can have a card of its own, ``gloo`` when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU. The
    ranks on this host are ``torchrun``'s ``LOCAL_WORLD_SIZE``, else
    ``world_size`` (one host)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device_type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_world(backend: str) -> None:
    """Start the default process group with ``backend`` unless one is
    running: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) when it is set, else as a world of
    one rank on an in-process store."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_host_mesh(device_type: str = "cuda"):
    """A 1 x 1 ``("data", "model")`` mesh for one process: the mesh-aware
    paths at world size 1 (NCCL on the card, gloo on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    init_world(world_backend(device_type, 1))
    if dist.get_world_size() != 1:
        raise ValueError(f"make_host_mesh: the running world has "
                         f"{dist.get_world_size()} ranks, not 1")
    keep_current_device(device_type)
    return DeviceMesh(device_type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=AXES)


def keep_current_device(device_type: str) -> None:
    """Initialise CUDA before a ``DeviceMesh`` is built on it: the mesh
    then keeps the caller's current device (it would otherwise pick one
    from ``LOCAL_RANK``, which names no card when ranks share one)."""
    if device_type == "cuda":
        torch.cuda.init()


def make_production_mesh(*, device_type: str = "cuda"):
    """The launched world (``torchrun``) as a ``(data, model)`` mesh of
    world x 1 (``runtime.elastic``'s plan at model_parallel 1: the model
    axis waits for ROADMAP.md queue 1, "The model axis"), on the backend
    of ``world_backend``'s rule."""
    from repro_torch.runtime import elastic

    world = int(os.environ.get("WORLD_SIZE", "1"))
    init_world(world_backend(device_type, world))
    plan = elastic.plan_mesh(dist.get_world_size(), model_parallel=1)
    return elastic.build_mesh(plan, device_type)
