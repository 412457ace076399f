"""Training launcher (port of ``repro/launch/train.py``): the sharded
state, the supervised, fault-tolerant step loop with checkpointing, a
heartbeat and straggler monitoring.

Runs on ``cuda`` unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \
      --smoke --device cpu --steps 8 --global-batch 4 --seq-len 32 \
      --ckpt-dir /tmp/ckpt

``--n-layers`` cuts the config's depth (full-width Llama-2-7B at 2 layers
and 4 x 4096 tokens, ``--n-layers 2 --seq-len 4096 --global-batch 4
--microbatches 2``, is what ``chip_smoke.py``'s train phase trains). The
last line gives the median seconds a step of the token draw and of the
train step. A second run with the same ``--ckpt-dir`` and more ``--steps``
resumes from the latest checkpoint. On a restore the token stream is put
back to the restored step, so a resumed run sees the batches an
uninterrupted one would have seen (the reference's stream keeps running
past the failed step).

The stream draws tokens only, as the reference's does: every family but
audio trains here (``--arch zamba2-7b`` included); whisper's forward needs
frames and refuses (``encdec.forward``'s ``ValueError``), as the
reference's asserts.

On several ranks (``torchrun``, or ``COORDINATOR_ADDRESS=host:port`` with
``RANK`` and ``WORLD_SIZE`` set for each process: the reference's
multi-host start) it trains on a ``(data, model)`` mesh with
``--model-parallel`` ranks on the model axis (``launch/mesh``: NCCL when
each rank on the host has a card, gloo otherwise) and the dense and moe
families: every rank makes the same state from seed 0 and keeps its
shards (placed as ``shardings_for`` gives them), each data rank draws
its own rows of the stream's global batch (shard ``data rank`` of ``data
ranks``), and rank 0 prints and writes the checkpoints (whole arrays:
the same files as a run on one device). For example, on the CPU:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
      repro_torch.launch.train --arch llama2-7b --smoke --device cpu \
      --model-parallel 2 --steps 8 --global-batch 4 --seq-len 32
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCHS, SMOKE
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.models import common as cm
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainState, init_state, make_train_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config to this many layers (full-depth "
                    "Llama-2-7B's training state does not fit one card)")
    return ap.parse_args(argv)


def shardings_for(mesh, model, state: TrainState) -> TrainState:
    """The train state's (mesh, spec) pairs: the parameters' specs
    (``model.param_specs``) and the optimizer state's
    (``optimizer.state_specs``), sanitized against the mesh."""
    from repro_torch.launch.mesh import NamedSharding

    pspecs = model.param_specs()
    specs = cm.sanitize_specs(state, TrainState(
        params=pspecs, opt=opt.state_specs(pspecs)), mesh)

    def pair(s):
        if isinstance(s, cm.P):
            return NamedSharding(mesh, s)
        if isinstance(s, dict):
            return {k: pair(v) for k, v in s.items()}
        if isinstance(s, list):
            return [pair(v) for v in s]
        return type(s)(*(pair(v) for v in s))

    return pair(specs)


def _on_mesh(args) -> bool:
    return (args.model_parallel > 1 or "WORLD_SIZE" in os.environ
            or bool(os.environ.get("COORDINATOR_ADDRESS")))


def run(args, before_step=None) -> ft.SuperviseResult:
    """Train as the command line says. ``before_step(i)``, when given, is
    called before step i runs (a test's way to inject a failure). The
    last line gives the median seconds a step of the batch's draw and of
    the train step after it."""
    dev = resolve_device(args.device)
    mesh, rank = None, 0
    if _on_mesh(args):
        import torch.distributed as dist

        from repro_torch.launch import mesh as mesh_lib

        mesh = mesh_lib.make_production_mesh(
            model_parallel=args.model_parallel, device_type=dev.type)
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if args.smoke:
        cfg = cfg.scaled(dtype="float32")
    if args.n_layers is not None:
        cfg = cfg.scaled(n_layers=args.n_layers)
    model = model_zoo.build(cfg)
    where = "" if mesh is None else (
        f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    say(f"arch={cfg.name} params={model_zoo.count_params(model)/1e6:.1f}M "
        f"device={dev}{where}", flush=True)
    ocfg = opt.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                         total_steps=args.steps)
    state = init_state(model, 0, ocfg, device=dev, mesh=mesh)
    step_fn = make_train_step(model, ocfg, microbatches=args.microbatches,
                              mesh=mesh)
    dp = 1 if mesh is None else cm.axis_sizes(mesh)["data"]
    stream = SyntheticStream(
        cfg.vocab_size, seq_len=args.seq_len, global_batch=args.global_batch,
        shard_id=0 if mesh is None else mesh.get_local_rank("data"),
        n_shards=dp, device=dev)
    ckpt = Checkpointer(args.ckpt_dir, keep=3, async_save=True)
    monitor = StragglerMonitor()
    split = []  # (draw seconds, step seconds) a step run

    def one_step(state, i):
        if before_step is not None:
            before_step(i)
        t0 = time.perf_counter()
        tokens = stream.next()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        loss = float(metrics["loss"])  # waits for the step
        t2 = time.perf_counter()
        rep = monitor.record(i, t2 - t0)
        split.append((t1 - t0, t2 - t1))
        if i % 10 == 0:
            say(f"step {i}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} draw "
                  f"{t1 - t0:.3f}s step {t2 - t1:.3f}s "
                  f"{'STRAGGLER' if rep.is_straggler else ''}", flush=True)
        return state

    def on_restore(state):
        stream.restore({"step": int(state.opt.step), "seed": stream.seed})
        return state

    res = ft.supervise(
        state=state, step_fn=one_step, ckpt=ckpt, total_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        heartbeat_path=(os.path.join(args.ckpt_dir, "heartbeat.json")
                        if rank == 0 else None),
        on_restore=on_restore)
    tail = ""
    if split:  # none when the checkpoint was already at --steps
        draw, step = (statistics.median(x) for x in zip(*split))
        tail = f"; median draw {draw:.4f}s step {step:.4f}s"
    say(f"done: {res.steps_done} steps, {res.restarts} restarts, "
          f"{res.straggler_flags} straggler flags{tail}", flush=True)
    return res


def main(argv=None) -> ft.SuperviseResult:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
