"""Elastic re-mesh on the PyTorch/CUDA port: plan a mesh, lose devices,
re-plan, and reshard a parameter tree onto the degraded mesh
(``examples/elastic_remesh.py``'s, through ``repro_torch.runtime.elastic``).

Run: PYTHONPATH=src python examples/torch_elastic_remesh.py [--ranks 8]
     [--device cpu]

The script starts ``--ranks`` ranks of itself under ``torchrun``
(``torch.distributed.run --standalone``, an environment cleared of rank
and rendezvous variables), as the repository's tests start theirs. The
ranks talk over gloo: on the card they share it (NCCL takes one card a
rank). Each rank builds the plan's ``DeviceMesh``, keeps its shards of
the tree (``elastic.reshard``), and after the loss of two devices the
ranks of the degraded plan reshard onto it (the spares sit it out); the
values are gathered back and compared. Rank 0 prints the figures, the
last line a JSON object.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "GROUP_RANK", "ROLE_RANK", "ROLE_WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT", "COORDINATOR_ADDRESS")


def plans(n_devices: int, model_parallel: int = 2, lost: int = 2):
    """The initial plan and the plan after losing ``lost`` devices."""
    from repro_torch.runtime import elastic

    plan = elastic.plan_mesh(n_devices, model_parallel=model_parallel,
                             pods=1)
    return plan, elastic.degrade_plan(plan, lost)


def remesh(device_type: str) -> dict:
    """One rank's part (in a running world): the tree on the initial
    plan's mesh and, on the degraded plan's ranks, on its mesh; whether
    the gathered values match the tree on both."""
    import torch.distributed as dist

    from repro_torch.models import common as cm
    from repro_torch.models import parallel as par
    from repro_torch.runtime import elastic

    n, rank = dist.get_world_size(), dist.get_rank()
    plan, plan2 = plans(n)
    dev = torch.device(device_type)
    params = {"w": torch.arange(64.0, device=dev).reshape(8, 8),
              "b": torch.ones(8, device=dev)}
    specs = {"w": cm.P("data", "model"), "b": cm.P(None)}
    mesh = elastic.build_mesh(plan, device_type)
    sharded = elastic.reshard(params, specs, mesh)
    fig = {"world": n, "plan": plan.__dict__, "degraded": plan2.__dict__,
           "placements": [str(p) for p in sharded["w"].placements],
           "local_shape": list(sharded["w"].to_local().shape)}
    ok = bool(torch.equal(par.whole(sharded["w"]), params["w"]))
    mesh2 = elastic.build_mesh(plan2, device_type)
    if rank < plan2.used:
        resharded = elastic.reshard(params, specs, mesh2)
        fig["new_placements"] = [str(p)
                                 for p in resharded["w"].placements]
        fig["new_local_shape"] = list(resharded["w"].to_local().shape)
        ok = ok and bool(torch.equal(par.whole(resharded["w"]), params["w"]))
        del resharded
    fig["values_preserved"] = ok
    del sharded, mesh, mesh2
    return fig


def rank_main(device_type: str) -> int:
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_world(mesh_lib.world_backend(
        device_type, int(os.environ["WORLD_SIZE"])))
    if device_type == "cuda":
        torch.cuda.set_device(0)  # the ranks share the one card
    fig = remesh(device_type)
    figs = [None] * dist.get_world_size()
    dist.all_gather_object(figs, fig)
    if dist.get_rank() == 0:
        print(f"devices available: {fig['world']} ranks")
        print(f"initial plan: {fig['plan']}")
        print(f"initial placements of w: {fig['placements']}, local "
              f"{fig['local_shape']}")
        print(f"after losing 2 devices: {fig['degraded']} "
              f"(spares={fig['degraded']['spares']})")
        print(f"new placements of w: {fig['new_placements']}, local "
              f"{fig['new_local_shape']}")
        ok = all(f["values_preserved"] for f in figs)
        print("values preserved across re-mesh — elastic path OK." if ok
              else "values NOT preserved across re-mesh")
        print(json.dumps({**fig, "values_preserved": ok}))
    code = 0 if all(f["values_preserved"] for f in figs) else 1
    mesh_lib.close_world()
    return code


def launch(n: int, device_type: str, timeout: int = 300) -> str:
    """Run ``n`` ranks of this script under torchrun; rank 0's output."""
    env = {k: v for k, v in os.environ.items()
           if k not in RANK_VARS and not k.startswith("TORCHELASTIC_")}
    env["OMP_NUM_THREADS"] = "1"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", os.path.abspath(__file__), "--rank",
         "--device", device_type], env=env, capture_output=True, text=True,
        timeout=timeout)
    if out.returncode:
        raise RuntimeError(f"torch_elastic_remesh: ranks failed "
                           f"({out.returncode}):\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    return out.stdout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--rank", action="store_true",
                    help="(internal) run as one rank under torchrun")
    args = ap.parse_args(argv)
    if args.rank:
        return rank_main(args.device)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run on the CPU")
    out = launch(args.ranks, args.device)
    print(out, end="")
    return json.loads(out.strip().splitlines()[-1])


if __name__ == "__main__":
    r = main()
    sys.exit(r if isinstance(r, int) else 0)
