"""Fault-tolerant training on the PyTorch/CUDA port: a supervised loop with
checkpointing, straggler monitoring, and a simulated failure and restart
(``examples/train_tiny.py``'s, through ``repro_torch``'s runtime layer).

Run: PYTHONPATH=src python examples/torch_train_tiny.py [--device cpu]
     [--steps 60]
"""
import argparse
import json
import os
import tempfile

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import init_state, make_train_step

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192,
                  vocab_size=512, dtype="float32", vocab_pad_multiple=64)


def run(device, steps: int = 60, fail_at: int = 25,
        checkpoint_every: int = 10, log=print) -> dict:
    """Train ``CFG`` for ``steps`` steps under ``fault_tolerance.
    supervise`` with a failure injected once at step ``fail_at``; the
    figures: steps done, restarts, and the losses logged every 10 steps."""
    model = model_zoo.build(CFG)
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    state = init_state(model, 0, ocfg, device=device)
    step = make_train_step(model, ocfg, microbatches=2)
    stream = SyntheticStream(CFG.vocab_size, seq_len=32, global_batch=8,
                             device=device)
    crashed = {"done": False}
    losses = {}

    def step_fn(state, i):
        if i == fail_at and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError(f"simulated node failure at step {fail_at}")
        state, metrics = step(state, {"tokens": stream.next()})
        if i % 10 == 0:
            losses[i] = float(metrics["loss"])
            log(f"  step {i}: loss={losses[i]:.3f}")
        return state

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=3, async_save=True)
        res = ft.supervise(
            state=state, step_fn=step_fn, ckpt=ck, total_steps=steps,
            checkpoint_every=checkpoint_every,
            heartbeat_path=os.path.join(d, "hb.json"))
    return {"steps_done": res.steps_done, "restarts": res.restarts,
            "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    fig = run(resolve_device(args.device), steps=args.steps)
    print(f"finished {fig['steps_done']} steps with {fig['restarts']} "
          f"restart(s) — training survived the failure.")
    print(json.dumps(fig))
    return fig


if __name__ == "__main__":
    main()
