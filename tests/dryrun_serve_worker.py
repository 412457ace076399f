"""One rank of the sharded-decode test (``test_torch_dryrun.py``), on the
CPU over gloo:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/ranks.py tests/dryrun_serve_worker.py <out.json>

Each case (an f32 smoke config, a batch, a mesh of the world's 2 ranks)
prefills a prompt and decodes three tokens twice: on one device, and on
the mesh with the dry run's placements (``dryrun.cache_shardings``, its
model axis ``parallel.serve_axis``, each rank's parameters, rows and
cache); the logits are gathered over the model axis and rank 0 writes
the worst |sharded - single| beside max|single| a case. Cases: the KV
heads over 'model' (KV 4 on a model axis of 2), the sequence over
'model' (KV 1), and at batch 1 the sequence over ('data', 'model').
Imports the port only.
"""
import json
import math
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import SMOKE
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo
from repro_torch.models import parallel as par
from repro_torch.serve.serve_step import make_decode, make_prefill

CASES = {
    "heads": dict(kw={}, batch=2, mesh=(1, 2)),
    "seq_model": dict(kw={"n_kv_heads": 1}, batch=2, mesh=(1, 2)),
    "seq_data_model": dict(kw={"n_kv_heads": 1}, batch=1, mesh=(2, 1)),
}
PROMPT, NEW, MAX_LEN = 12, 3, 32


def decode_logits(model, params, tokens, cache, axis=None):
    """The prefill's last logits and each decode step's."""
    out = []
    logits, cache = make_prefill(model, last_only=True, axis=axis)(
        params, {"tokens": tokens[:, :PROMPT]}, cache)
    out.append(logits[:, -1])
    step = make_decode(model, axis=axis)
    for i in range(NEW):
        pos = PROMPT + i
        logits, cache = step(params, tokens[:, pos:pos + 1], cache, pos)
        out.append(logits[:, -1])
    return torch.stack(out, 1)


def run_case(case) -> dict:
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", **case["kw"])
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    B = case["batch"]
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT + NEW),
                           generator=gen)
    ref = decode_logits(model, params, tokens,
                        model.init_cache(B, MAX_LEN, dtype=torch.float32,
                                         device="cpu"))
    mesh = DeviceMesh("cpu", torch.arange(math.prod(case["mesh"])).reshape(
        case["mesh"]), mesh_dim_names=("data", "model"))
    whole = model.init_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    specs = dryrun.cache_shardings(model, mesh, whole)
    specs, _ = dryrun.port_cache_specs(cfg, specs)
    axis = par.serve_axis(mesh, dryrun.kv_spec(specs))
    layout = par.Layout(model, mesh, axis=axis)
    rows = par.rank_rows({"tokens": tokens}, axis)["tokens"]
    got = decode_logits(model, layout.rank_params(params), rows,
                        par.rank_tree(whole, specs, mesh), axis)
    if axis.vocab(cfg) is not None:
        got = par.all_gather(got, -1, axis.model_group)
    if rows.shape[0] != B:
        got = par.all_gather(got, 0, axis.data_group)
    return {"kv_spec": list(map(str, dryrun.kv_spec(specs))),
            "seq_n": axis.cache.seq_n, "heads": axis.cache.heads,
            "max_err": float((got - ref).abs().max()),
            "max_rel_err": float(((got - ref).abs()
                                  / (ref.abs() + 1e-30)).max()),
            "ok": bool(((got - ref).abs() <= 1e-5 * ref.abs()
                        + 1e-6 * ref.abs().max()).all()),
            "max_ref": float(ref.abs().max())}


def main(out_path: str) -> int:
    mesh_lib.init_world("gloo")
    res = {name: run_case(case) for name, case in CASES.items()}
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    dist.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
