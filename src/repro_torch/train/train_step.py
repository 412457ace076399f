"""Microbatched, remat'd train step on one device (port of
``repro/train/train_step.py``).

The reference scans its microbatches inside one jitted step; here a Python
loop takes each microbatch's gradient with ``torch.autograd.grad`` and
adds it to an accumulator, ``(g.float() / microbatches).to(acc_dtype)``,
as the reference does, so the live activation set is one microbatch deep.
``remat`` goes to the model's forward (``True``: each block checkpointed,
the hybrid's each group, audio's each encoder and decoder layer;
``"save_attn"``: a dense or moe block checkpointed around the attention,
which is not re-run). Every leaf of the batch (``tokens``, and audio's
``frames``) is split by microbatch along its first axis.
The loss is the reference's: ``ce + aux`` on the last S positions' logits
in f32, with the metrics averaged over the microbatches.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import homogeneous
from repro_torch.train import loss as loss_lib
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamWState


def init_state(model: Model, seed: int, opt_cfg: opt.OptConfig,
               device=None) -> TrainState:
    params = model.init_params(seed=seed, device=device)
    return TrainState(params=params, opt=opt.init(params, opt_cfg))


def loss_and_grads(model: Model, params, batch: dict, *,
                   microbatches: int = 1, remat=True,
                   grad_accum_dtype: str = "float32"):
    """(grads, metrics) of one step's loss: the microbatches' gradients
    accumulated in ``grad_accum_dtype`` (a tree like ``params``) and the
    loss, nll and ppl_proxy averaged over them (0-dim f32 tensors)."""
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"global batch {B} does not split into "
                         f"{microbatches} microbatches")
    mb_size = B // microbatches
    acc_dt = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[grad_accum_dtype]
    leaves = opt.tree_leaves(params)
    acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
           for p in leaves]
    dev = batch["tokens"].device
    metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in ("loss", "nll", "ppl_proxy")}
    for i in range(microbatches):
        mb = {k: x[i * mb_size:(i + 1) * mb_size] for k, x in batch.items()}
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            logits, _, aux = model.forward(
                opt.tree_unflatten(params, live), mb, remat=remat)
            S = mb["tokens"].shape[1]
            ce, m = loss_lib.next_token_loss(
                logits[:, -S:, :].to(torch.float32), mb["tokens"])
            loss = ce + aux
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:  # a leaf the loss does not reach adds 0
                a.add_((g.to(torch.float32) / microbatches).to(acc_dt))
        m = dict(m, loss=loss)
        for k in metrics:
            metrics[k] = metrics[k] + m[k].detach() / microbatches
        del logits, loss, grads, live
    return opt.tree_unflatten(params, acc), metrics


def make_train_step(model: Model, opt_cfg: opt.OptConfig,
                    microbatches: int = 1, remat=True):
    """Returns train_step(state, batch) -> (state, metrics). The state it
    is given is left as it was."""
    param_dtype = cm.DTYPES[model.cfg.dtype]
    # whether the reference stacks the layer lists (optimizer.decay_mask)
    stacked = (model.cfg.family in ("hybrid", "audio")
               or homogeneous(model.cfg))

    def train_step(state: TrainState, batch):
        grads, metrics = loss_and_grads(
            model, state.params, batch, microbatches=microbatches,
            remat=remat, grad_accum_dtype=opt_cfg.grad_accum_dtype)
        new_params, new_opt, opt_metrics = opt.update(
            opt_cfg, grads, state.opt, param_dtype=param_dtype,
            stacked_layers=stacked)
        metrics.update(opt_metrics)
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
