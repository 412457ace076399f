"""Training launcher on one device (port of ``repro/launch/train.py``):
the supervised, fault-tolerant step loop with checkpointing, a heartbeat
and straggler monitoring.

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

Not ported yet (ROADMAP.md queue 1, "The model axis"): a mesh
(``--model-parallel`` > 1) and the multi-host start (``COORDINATOR_ADDRESS``).
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
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import init_state, make_train_step

_MESH_ENTRY = "The model axis"


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


def run(args, before_step=None) -> ft.SuperviseResult:
    """Train as the command line says. ``before_step(i)``, when given, is
    called before step i runs (a test's way to inject a failure). The
    last line gives the median seconds a step of the batch's draw and of
    the train step after it."""
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: a mesh is not ported "
            f"yet (ROADMAP.md queue 1, {_MESH_ENTRY!r})")
    if os.environ.get("COORDINATOR_ADDRESS"):
        raise NotImplementedError(
            "COORDINATOR_ADDRESS: multi-host training is not ported yet "
            f"(ROADMAP.md queue 1, {_MESH_ENTRY!r})")
    dev = resolve_device(args.device)
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if args.smoke:
        cfg = cfg.scaled(dtype="float32")
    if args.n_layers is not None:
        cfg = cfg.scaled(n_layers=args.n_layers)
    model = model_zoo.build(cfg)
    print(f"arch={cfg.name} params={model_zoo.count_params(model)/1e6:.1f}M "
          f"device={dev}", flush=True)
    ocfg = opt.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                         total_steps=args.steps)
    state = init_state(model, 0, ocfg, device=dev)
    step_fn = make_train_step(model, ocfg, microbatches=args.microbatches)
    stream = SyntheticStream(cfg.vocab_size, seq_len=args.seq_len,
                             global_batch=args.global_batch, device=dev)
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
            print(f"step {i}: loss={loss:.4f} "
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
        heartbeat_path=os.path.join(args.ckpt_dir, "heartbeat.json"),
        on_restore=on_restore)
    tail = ""
    if split:  # none when the checkpoint was already at --steps
        draw, step = (statistics.median(x) for x in zip(*split))
        tail = f"; median draw {draw:.4f}s step {step:.4f}s"
    print(f"done: {res.steps_done} steps, {res.restarts} restarts, "
          f"{res.straggler_flags} straggler flags{tail}", flush=True)
    return res


def main(argv=None) -> ft.SuperviseResult:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
