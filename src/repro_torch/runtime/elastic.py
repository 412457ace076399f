"""Elastic re-meshing (port of ``repro/runtime/elastic.py``): recompute the
device mesh after capacity changes.

Policy, as the reference's: keep the model (tensor-parallel) axis fixed,
absorb capacity changes into the data axis, and leave remainder devices as
hot spares. ``MeshPlan``, ``plan_mesh`` and ``degrade_plan`` are the
reference's integer arithmetic; ``build_mesh`` lays a plan's ranks out as
a ``torch.distributed`` ``DeviceMesh``. ``reshard`` moves a (restored)
tree onto a new mesh: its specs sanitized against that mesh, so a dim a
degraded mesh no longer divides is replicated rather than failing the
restart.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pod: int
    data: int
    model: int
    spares: int

    @property
    def used(self) -> int:
        return self.pod * self.data * self.model


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              pods: int = 1) -> MeshPlan:
    """Largest (pod, data, model) grid fitting n_devices with fixed TP."""
    if n_devices < model_parallel * pods:
        raise ValueError(f"{n_devices} devices cannot hold {pods} pod(s) of "
                         f"model_parallel {model_parallel}")
    per_pod = n_devices // pods
    data = per_pod // model_parallel
    used = pods * data * model_parallel
    return MeshPlan(pod=pods, data=data, model=model_parallel,
                    spares=n_devices - used)


def degrade_plan(plan: MeshPlan, lost_devices: int) -> MeshPlan:
    """Re-plan after losing devices; spares absorb losses first."""
    remaining = plan.used + plan.spares - lost_devices
    return plan_mesh(remaining, model_parallel=plan.model, pods=plan.pod)


def build_mesh(plan: MeshPlan, device_type: str = "cuda"):
    """The plan's first ``plan.used`` ranks of the running process group as
    a ``DeviceMesh``: axes ``("data", "model")``, or ``("pod", "data",
    "model")`` with more than one pod. Every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import keep_current_device

    keep_current_device(device_type)
    ranks = torch.arange(plan.used, dtype=torch.int64)
    if plan.pod == 1:
        return DeviceMesh(device_type, ranks.reshape(plan.data, plan.model),
                          mesh_dim_names=("data", "model"))
    return DeviceMesh(device_type,
                      ranks.reshape(plan.pod, plan.data, plan.model),
                      mesh_dim_names=("pod", "data", "model"))


def reshard(tree, specs, mesh):
    """``tree`` (whole tensors, or DTensors on another mesh, gathered
    first) as DTensors on ``mesh``, each placed by its spec in ``specs``
    sanitized against ``mesh``. Every rank holds the same whole tree (as
    after a restore), so each keeps its own shards: no collective but the
    gathers."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import parallel as par

    specs = cm.sanitize_specs(tree, specs, mesh)

    def put(x, spec):
        if isinstance(x, DTensor):
            x = par.whole(x)
        return cm.place(x, mesh, cm.placements(spec, mesh))

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, s)]
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(a, b) for a, b in zip(t, s)))
        return put(t, s)

    return walk(tree, specs)
