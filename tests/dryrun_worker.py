"""The dry-run tests' fake worlds (``test_torch_dryrun.py``), in a process
of their own so that no test process keeps a default process group:

    python tests/dryrun_worker.py <out.json> <cells dir>

For every family's smoke config (``FAMILY_REPRESENTATIVE``; the xLSTM's
cut to one mLSTM and one sLSTM block): ``run_cell``
at a small shape of each kind (train, prefill, decode, decode with
``--vq``; long_500k for the recurrent families) on a fake world of 8 as a
(4, 2) mesh, on the CPU, its record saved under <cells dir>; the
all-gather bytes the train cell counted beside the bytes its ``Layout``
gives (``views``: each leaf gathered over the data axis, then over the
model axis unless the forward reads its shard); and at mesh (1, 1) the
traced FLOPs of the steps in ``HELD`` beside ``FlopCounterMode`` on the
same step run for real (``dryrun.measure``). Imports the port
only.
"""
import json
import sys

import torch

from repro_torch.configs import FAMILY_REPRESENTATIVE, SMOKE
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.bpv import VQConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo
from repro_torch.models import parallel as par
from repro_torch.train import optimizer as opt

MESH = ((4, 2), ("data", "model"))
ONE = ((1, 1), ("data", "model"))
SHAPES = {"train": ShapeConfig("train_4k", 24, 8, "train"),
          "prefill": ShapeConfig("prefill_32k", 24, 8, "prefill"),
          "decode": ShapeConfig("decode_32k", 32, 8, "decode"),
          "long": ShapeConfig("long_500k", 32, 1, "decode")}
# the steps also run for real at mesh (1, 1): every family's decode, the
# dense and moe families' train step (the recurrent and encoder-decoder
# train steps trace alone: their time loops make a real CPU step slow)
HELD = {"train": ("dense", "moe"),
        "decode": ("audio", "dense", "hybrid", "moe", "ssm", "vlm")}
# the recurrent and encoder-decoder families' train and prefill cells at 8
# tokens (their time loops and encoder make each token cost more to trace)
SHORT = {"ssm", "hybrid", "audio"}
# small column groups, so the smoke widths split over the model axis
VQ_SMOKE = VQConfig(d=2, bits_per_dim=2, group_size=256, group_cols=32)


def expected_all_gathers(cfg, mesh_shape) -> dict:
    """The all-gather output bytes of one train step's ``Layout.views``
    on ``mesh_shape``, by axis, from the layout and the leaves' shapes."""
    mesh = mesh_lib.fake_mesh(*mesh_shape, device_type="cpu")
    model = model_zoo.build(cfg)
    layout = par.Layout(model, mesh)
    shapes = model_zoo.abstract_params(model)
    size = dict(zip(mesh_shape[1], mesh_shape[0]))
    out = {"data": 0, "model": 0}
    for t, leaf in zip(opt.tree_leaves(shapes), layout.of(shapes)):
        whole = t.numel() * t.element_size()
        local = whole
        for dim, name in ((leaf.data_dim, "data"), (leaf.model_dim, "model")):
            if dim is not None:
                local //= size[name]
        if leaf.data_dim is not None and size["data"] > 1:
            local *= size["data"]
            out["data"] += local
        if (leaf.model_dim is not None and leaf.mode != par.SPLIT
                and size["model"] > 1):
            out["model"] += local * size["model"]
    del layout, mesh
    mesh_lib.close_world()
    return out


def real_batch(cfg, shape, kind):
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k, v in dryrun.abstract_batch(cfg, shape, kind).items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape,
                                   generator=gen).to(torch.int32)
        else:
            out[k] = torch.randn(v.shape, generator=gen).to(v.dtype)
    return out


def flops_held(arch, cfg, kind) -> dict:
    shape = SHAPES[kind]
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    batch = real_batch(cfg, shape, kind)
    traced = dryrun.run_cell(arch, shape.name, cfg=cfg, shape=shape,
                             mesh_shape=ONE, device="cpu", save=False,
                             sources={"params": params, "batch": batch})
    mesh = mesh_lib.make_host_mesh("cpu")
    cell = dryrun.build_cell(arch, shape.name, cfg=cfg, shape=shape,
                             mesh=mesh, device="cpu",
                             sources={"params": params, "batch": batch})
    real = dryrun.measure(cell)
    del cell, mesh
    mesh_lib.close_world()
    return {"traced": traced["flops"]["total"], "measured": real["flops"],
            "status": traced["status"]}


def main(out_path: str, cells_dir: str) -> int:
    res = {"cells": {}, "gathers": {}, "flops": {}}
    for fam, arch in sorted(FAMILY_REPRESENTATIVE.items()):
        cfg = SMOKE[arch]
        if fam == "ssm":  # one mLSTM and one sLSTM block
            cfg = cfg.scaled(n_layers=2, slstm_layers=(1,))
        kinds = ["train", "prefill", "decode", "vq"]
        if fam in ("ssm", "hybrid"):
            kinds.append("long")
        for kind in kinds:
            shape = SHAPES["decode" if kind == "vq" else kind]
            if fam in SHORT and kind in ("train", "prefill"):
                shape = ShapeConfig(shape.name, 8, 8, shape.kind)
            r = dryrun.run_cell(arch, shape.name, cfg=cfg, shape=shape,
                                vq=kind == "vq", mesh_shape=MESH,
                                device="cpu", vq_cfg=VQ_SMOKE,
                                out_dir=cells_dir)
            res["cells"][f"{fam}/{kind}"] = {
                k: r.get(k) for k in ("status", "error", "fits", "memory",
                                      "flops", "collectives", "gaps")}
        gathers = res["cells"][f"{fam}/train"]["collectives"] or {}
        res["gathers"][fam] = {
            "counted": gathers.get("all-gather", {}),
            "layout": expected_all_gathers(cfg, MESH)}
        for kind, fams in HELD.items():
            if fam in fams:
                res["flops"][f"{fam}/{kind}"] = flops_held(arch, cfg, kind)
    res["stepwise"] = stepwise_held()
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


def stepwise_held() -> dict:
    """An xLSTM prefill cell past ``STEPWISE_TOKENS`` (traced at those
    two lengths and extended) beside the same cell traced token by
    token."""
    cfg = SMOKE["xlstm-125m"].scaled(n_layers=2, slstm_layers=(1,))
    shape = ShapeConfig("prefill_32k", 48, 8, "prefill")
    ext = dryrun.run_cell("xlstm-125m", shape.name, cfg=cfg, shape=shape,
                          mesh_shape=MESH, device="cpu", save=False)
    meta, _, arg_bytes, counts, _ = dryrun._traced(
        "xlstm-125m", shape.name, shape, multi_pod=False, vq=False,
        kv8=False, device="cpu", cfg=cfg, mesh_shape=MESH,
        vq_cfg=dryrun.SERVE_VQ, microbatches=None, opt_cfg=None,
        sources=None)
    return {"extended": [ext["flops"]["total"], ext["memory"]["peak_bytes"],
                         ext["collectives"]["total"],
                         ext["stepwise_traced_tokens"]],
            "direct": [counts["flops"], arg_bytes + counts["peak_step_bytes"],
                       counts["work"]["collectives"]["total"]]}


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
