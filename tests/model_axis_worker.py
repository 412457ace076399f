"""One rank of ``test_torch_model_axis.py``'s process groups, on the CPU
over gloo:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/model_axis_worker.py <cases.pt> <out dir>

``cases.pt`` (``torch.save``) holds a list of case dicts, each with a
``kind``, a ``name`` and a ``mesh`` (data, model); the worker runs, in
order, every case whose mesh holds the world's ranks, and rank 0 writes
``<out dir>/<name>.pt``. Imports the port only.
"""
import math
import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SMOKE
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, model_zoo, moe
from repro_torch.models import parallel as par
from repro_torch.runtime import elastic
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainState, data_rows, init_state, loss_and_grads, make_train_step)


def mesh_of(shape):
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))


def whole(tree):
    """A tree with every DTensor leaf gathered (a collective)."""
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [whole(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(whole(v) for v in tree))
    return par.whole(tree) if hasattr(tree, "device_mesh") else tree


def build(case):
    cfg = SMOKE[case["arch"]].scaled(**case["kw"])
    return cfg, model_zoo.build(cfg)


def run_step(case, mesh):
    """Step 1's gradients and metrics, then ``steps`` train steps from
    ``params``: the whole gradients, metrics and final params, and the
    flash and expert-parallel calls the gradient pass made."""
    cfg, model = build(case)
    ocfg = opt.OptConfig(**case["ocfg"])
    mb = case["microbatches"]
    params = elastic.reshard(case["params"], model.param_specs(), mesh)
    state = TrainState(params, opt.init(params, ocfg))
    batches = [data_rows({"tokens": t}, mesh, mb) for t in case["tokens"]]
    layout = par.Layout(model, mesh)
    flash0, ep0 = attention._FLASH_COUNTS["fused"], moe._apply_ep.calls
    views, m1 = loss_and_grads(
        model, opt.tree_unflatten(params, layout.views(params)), batches[0],
        microbatches=mb, remat=case["remat"], axis=layout.axis)
    calls = {"flash": attention._FLASH_COUNTS["fused"] - flash0,
             "ep": moe._apply_ep.calls - ep0}
    grads = whole(layout.grads(params, opt.tree_leaves(views)))
    step = make_train_step(model, ocfg, microbatches=mb, remat=case["remat"],
                           mesh=mesh)
    trace = []
    for b in batches:
        state, m = step(state, b)
        trace.append({k: float(v) for k, v in m.items()})
    return {"grads": grads, "metrics": {k: float(v) for k, v in m1.items()},
            "trace": trace, "params": whole(state.params), "calls": calls,
            "modes": {".".join(map(str, path)): leaf.mode
                      for path, leaf in layout.leaves.items()}}


def run_ep(case, mesh):
    """``moe._apply_ep`` on the rank's rows and experts, one backward of
    sum(y * dy) + aux; every rank's outputs and gradients, gathered."""
    cfg, _ = build(case)
    axis = par.ModelAxis(mesh)
    n = cfg.n_experts // axis.tp
    lo = axis.model_rank * n
    p = {k: (v if k == "router" else v[lo:lo + n]).clone().requires_grad_()
         for k, v in case["p"].items()}
    rows = data_rows({"x": case["x"], "dy": case["dy"]}, mesh)
    x = rows["x"].clone().requires_grad_()
    y, aux, keep = moe._apply_ep(p, cfg, x, axis)
    # this data rank's part of sum(y * dy) + aux over the whole batch
    part = (y * rows["dy"]).sum() + aux / axis.dp
    grads = torch.autograd.grad(part, [x] + [p[k] for k in sorted(p)])
    mine = {"data": axis.data_rank, "model": axis.model_rank,
            "y": y.detach(), "aux": aux.detach(), "keep": keep,
            "grads": dict(zip(["x"] + sorted(p), grads))}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {"ranks": every}


def train_state(case, mesh):
    cfg, model = build(case)
    ocfg = opt.OptConfig(**case["ocfg"])
    return model, ocfg, init_state(model, 0, ocfg, device="cpu", mesh=mesh)


def run_ckpt_save(case, mesh):
    """Two steps on the mesh, an async save at step 2 and the whole state
    then; step 3 from that state and from its restore on the same mesh
    (``restore(shardings=)``)."""
    model, ocfg, state = train_state(case, mesh)
    step = make_train_step(model, ocfg, mesh=mesh)
    for t in case["tokens"][:2]:
        state, _ = step(state, data_rows({"tokens": t}, mesh))
    ckpt = Checkpointer(case["dir"], async_save=True)
    ckpt.save(2, state, metadata={"mesh": list(mesh.shape)})
    ckpt.wait()
    at2 = whole(state)
    last = data_rows({"tokens": case["tokens"][2]}, mesh)
    back, _ = ckpt.restore(state, step=2, shardings=launch_train
                           .shardings_for(mesh, model, state))
    s3, _ = step(state, last)
    r3, _ = step(back, last)
    return {"state": at2, "step3": whole(s3.params),
            "step3_restored": whole(r3.params)}


def run_ckpt_restore(case, mesh):
    """The step-2 checkpoint restored on this mesh two ways: through
    ``restore(shardings=)`` and through a whole restore then
    ``elastic.reshard``; both gathered."""
    model, ocfg, like = train_state(case, mesh)
    ckpt = Checkpointer(case["dir"])
    sh = launch_train.shardings_for(mesh, model, like)
    a, meta = ckpt.restore(like, step=2, shardings=sh)
    placed = all(x.placements == y.placements for x, y in zip(
        opt.tree_leaves(a.params), opt.tree_leaves(like.params)))
    whole_like = init_state(model, 0, ocfg, device="cpu")
    b, _ = ckpt.restore(whole_like, step=2)
    pspecs = model.param_specs()
    b = elastic.reshard(b, TrainState(pspecs, opt.state_specs(pspecs)), mesh)
    return {"shardings": whole(a), "reshard": whole(b), "meta": meta,
            "placed": placed}


def run_supervise(case, mesh):
    """``launch.train.run`` on the mesh's ranks with a failure injected
    before step 3, and the same run without it."""
    out = {}
    for tag, fail_at in (("failed", 3), ("clean", None)):
        args = launch_train.parse_args(case["args"] + [
            "--ckpt-dir", os.path.join(case["dir"], tag)])
        fails = []

        def before(i, fail_at=fail_at, fails=fails):
            if i == fail_at and not fails:
                fails.append(i)
                raise RuntimeError("injected failure")

        res = launch_train.run(args, before_step=before)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (res.steps_done, res.restarts))
        out[tag] = {"ranks": every, "state": whole(res.final_state)}
    return out


KINDS = {"step": run_step, "ep": run_ep, "ckpt_save": run_ckpt_save,
         "ckpt_restore": run_ckpt_restore, "supervise": run_supervise}


def main(cases_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    world = dist.get_world_size()
    cases = torch.load(cases_path, weights_only=False)
    for case in cases:
        if math.prod(case["mesh"]) != world:
            continue
        mesh = mesh_of(case["mesh"])
        res = KINDS[case["kind"]](case, mesh)
        if dist.get_rank() == 0:
            torch.save(res, os.path.join(out_dir, f"{case['name']}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
