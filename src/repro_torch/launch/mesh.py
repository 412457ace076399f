"""Device meshes (port of ``repro/launch/mesh.py``): ``torch.distributed``
``DeviceMesh``es with the reference's axis names, ``("data", "model")``.

Defined as functions, so importing this module starts no process group.
A mesh needs the default process group: the mesh functions start it
(``init_world``) on the backend of ``world_backend``'s rule (NCCL when
each rank on the host has a card of its own, gloo when ranks share one
card or run on the CPU): from ``COORDINATOR_ADDRESS`` (``host:port``, with
``RANK`` and ``WORLD_SIZE``: the port's counterpart of the reference's
``jax.distributed.initialize()``), from ``torchrun``'s environment, or,
for a world of one, from an in-process store. ``NamedSharding`` pairs a
mesh with a spec (``models/common.P``), as the reference's.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.models import common as cm

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


def local_world(device_type: str, world_size: int) -> tuple[int, int]:
    """(this rank's index among the ranks on its host, their count):
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, which ``torchrun`` sets. A
    ``COORDINATOR_ADDRESS`` start without them has only ``RANK`` and
    ``WORLD_SIZE``: on the CPU, or where the world has no more ranks than
    this host has cards, ``RANK`` serves as the card (distinct ranks take
    distinct cards, on one host or several); otherwise which ranks share
    this host is unknown, and it raises. Without either, one host:
    ``RANK`` of ``world_size``."""
    env = os.environ
    local = {k: int(env[k]) for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")
             if k in env}
    if (env.get("COORDINATOR_ADDRESS") and device_type == "cuda"
            and len(local) < 2 and world_size > torch.cuda.device_count()):
        raise ValueError(
            f"COORDINATOR_ADDRESS: a world of {world_size} ranks on hosts "
            f"of {torch.cuda.device_count()} card(s) needs LOCAL_RANK and "
            "LOCAL_WORLD_SIZE (this rank's index among the ranks on its "
            "host, and their count) to choose the backend and the card")
    return (local.get("LOCAL_RANK", int(env.get("RANK", "0"))),
            local.get("LOCAL_WORLD_SIZE", world_size))


def world_backend(device_type: str, world_size: int) -> str:
    """The backend for ranks on ``device_type``: ``nccl`` when each rank
    on this host can have a card of its own, ``gloo`` when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU. The
    ranks on this host are ``local_world``'s."""
    _, local = local_world(device_type, world_size)
    if device_type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


class NamedSharding(NamedTuple):
    """A mesh and a spec: where a tensor lives (the reference's
    ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Any

    def placements(self) -> list:
        return cm.placements(self.spec, self.mesh)


def init_world(backend: str) -> None:
    """Start the default process group with ``backend`` unless one is
    running: from ``COORDINATOR_ADDRESS`` (``tcp://`` at that address,
    rank and world from ``RANK`` and ``WORLD_SIZE``), from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set, else as a world of one rank on an
    in-process store. Under NCCL each launched rank takes the card of its
    index on its host (``local_world``)."""
    if dist.is_initialized():
        return
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if backend == "nccl" and (addr or "LOCAL_RANK" in os.environ):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        torch.cuda.set_device(local_world("cuda", world)[0])
    if addr:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def close_world() -> None:
    """End this process's part in the world: destroy the default process
    group (if one runs), then collect the garbage that still refers to
    its groups, so that their threads (gloo's ``gloo_tcp_loop`` and
    ``pt_gloo_runloop``) are joined while the interpreter is whole. A
    group outlives ``destroy_process_group`` while a ``DeviceMesh`` or a
    DTensor refers to it, and its threads left running into interpreter
    shutdown abort a rank now and then after its work is done
    (``terminate called without an active exception``). Call it after
    the last reference to the mesh and the state is dropped."""
    import gc

    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


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


def make_production_mesh(*, model_parallel: int = 1,
                         device_type: str = "cuda"):
    """The launched world (``torchrun`` or ``COORDINATOR_ADDRESS``) as a
    ``(data, model)`` mesh: ``runtime.elastic``'s plan at
    ``model_parallel`` (the model axis fixed, the data axis absorbing the
    rest), on the backend of ``world_backend``'s rule."""
    from repro_torch.runtime import elastic

    world = int(os.environ.get("WORLD_SIZE", "1"))
    init_world(world_backend(device_type, world))
    plan = elastic.plan_mesh(dist.get_world_size(),
                             model_parallel=model_parallel)
    return elastic.build_mesh(plan, device_type)
