"""Fault tolerance: checkpoint/restart supervision for long training runs
(port of ``repro/runtime/fault_tolerance.py``; host logic, on the port's
``Checkpointer``).

``supervise`` wraps a step loop: on any step failure it restores the latest
checkpoint, hands it to ``on_restore`` and resumes. In a world of several
ranks (a train state on a mesh) every rank restores the step rank 0 finds
latest, after the pending save has landed. Heartbeats
are written per step so an external watchdog (k8s liveness / SLURM prolog)
can detect a hung job and recycle the pod — on thousands of nodes, crash
loops are routine and the recovery path must be the *default* path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class SuperviseResult:
    final_state: Any
    steps_done: int
    restarts: int
    straggler_flags: int


def write_heartbeat(path: str, step: int, extra: dict | None = None):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "time": time.time(), **(extra or {})}, f)
    os.replace(tmp, path)


def _latest_step(ckpt: Checkpointer) -> int | None:
    """The checkpoint to restore: rank 0's latest, on every rank."""
    import torch.distributed as dist

    step = ckpt.latest_step()
    if dist.is_initialized() and dist.get_world_size() > 1:
        box = [step]
        dist.broadcast_object_list(box, src=0)
        step = box[0]
    return step


def supervise(
    *,
    state: Any,
    step_fn: Callable[[Any, int], Any],       # (state, step) -> state
    ckpt: Checkpointer,
    total_steps: int,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    heartbeat_path: str | None = None,
    on_restore: Callable[[Any], Any] | None = None,
) -> SuperviseResult:
    """Run step_fn to total_steps with checkpoint/restart on failure (a
    DTensor state is restored on its own mesh and placements)."""
    monitor = StragglerMonitor()
    restarts = 0
    start = _latest_step(ckpt) or 0
    if start > 0:
        state, _ = ckpt.restore(state, step=start)
        if on_restore:
            state = on_restore(state)
    step = start
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(state, step)
            monitor.record(step, time.perf_counter() - t0)
            step += 1
            if heartbeat_path:
                write_heartbeat(heartbeat_path, step)
            if step % checkpoint_every == 0 or step == total_steps:
                ckpt.save(step, state)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait()  # an async save of an earlier step lands first
            restore_step = _latest_step(ckpt)
            if restore_step is None:
                raise
            state, _ = ckpt.restore(state, step=restore_step)
            if on_restore:
                state = on_restore(state)
            step = restore_step
    ckpt.wait()
    return SuperviseResult(state, step, restarts, len(monitor.flagged))
