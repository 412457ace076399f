"""Microbatched, remat'd train step, on one device or on a ``("data",
"model")`` mesh (port of ``repro/train/train_step.py``).

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

On a mesh (``mesh=``; every family) the state is DTensors placed by the
sanitized ``param_specs`` (``models/parallel.Layout``): parameters, m, v
and master alike, the step replicated, and so are the gradients
``update`` gets. A step gathers the weights its forward reads from their
shards, runs the rank's work under the model axis (``models/parallel``:
its heads, hidden units, vocabulary columns, experts, Mamba2 and xLSTM
heads) on its data rank's rows, and turns the gradients into the shards'.
The batch is split over the data axis and replicated over the model axis:
``data_rows`` gives a data rank its block of every microbatch, every leaf
of the batch alike (the vlm's patches and audio's frames beside the
tokens; with one microbatch, one block of rows of the global batch), so
each microbatch is the one the single-device step sees and the loss and
metrics are the global batch's, as under the reference's GSPMD. A data rank's loss is its part
of the objective (its rows' mean over the data ranks); the gradients are
summed over the data ranks.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import common as cm
from repro_torch.models import parallel as par
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import homogeneous
from repro_torch.train import loss as loss_lib
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamWState


def init_state(model: Model, seed: int, opt_cfg: opt.OptConfig,
               device=None, mesh=None) -> TrainState:
    """The state from ``seed``; on a ``mesh`` every rank makes the same
    whole parameters and keeps its shards (the single-device values)."""
    from repro_torch.runtime import elastic

    params = model.init_params(seed=seed, device=device)
    if mesh is not None:
        params = elastic.reshard(params, model.param_specs(), mesh)
    return TrainState(params=params, opt=opt.init(params, opt_cfg))


def data_rows(batch: dict, mesh, microbatches: int = 1) -> dict:
    """A data rank's rows of a global batch on ``mesh``: its block of each
    of the ``microbatches`` microbatches, in order."""
    sizes = cm.axis_sizes(mesh)
    dp, r = sizes.get("data", 1), mesh.get_local_rank("data")

    def rows(x):
        if x.shape[0] % (microbatches * dp):
            raise ValueError(f"global batch {x.shape[0]} does not split "
                             f"into {microbatches} microbatches of {dp} "
                             "data ranks")
        return x.reshape(microbatches, dp, -1, *x.shape[1:])[:, r].reshape(
            -1, *x.shape[1:])

    return {k: rows(x) for k, x in batch.items()}


def _data_sum(values: list, axis):
    """``values`` (0-dim f32 tensors) summed over the data ranks."""
    if axis is None or axis.dp == 1:
        return values
    return list(par.all_reduce(torch.stack(values), axis.data_group))


def loss_and_grads(model: Model, params, batch: dict, *,
                   microbatches: int = 1, remat=True,
                   grad_accum_dtype: str = "float32", axis=None):
    """(grads, metrics) of one step's loss: the microbatches' gradients
    accumulated in ``grad_accum_dtype`` (a tree like ``params``) and the
    loss, nll and ppl_proxy averaged over them (0-dim f32 tensors).

    ``axis`` (a ``parallel.ModelAxis``): ``params`` are the tensors the
    rank's forward reads (``Layout.views``) and ``batch`` its data rank's
    rows; the forward runs under the axis, the gradients are the rank's
    (a part of the data ranks' sum) and the metrics the global batch's."""
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
    dp = 1 if axis is None else axis.dp
    split = None if axis is None else axis.vocab(model.cfg)
    for i in range(microbatches):
        mb = {k: x[i * mb_size:(i + 1) * mb_size] for k, x in batch.items()}
        with torch.enable_grad(), par.using(axis):
            live = [p.detach().requires_grad_(True) for p in leaves]
            logits, _, aux = model.forward(
                opt.tree_unflatten(params, live), mb, remat=remat)
            S = mb["tokens"].shape[1]
            lg = logits[:, -S:, :].to(torch.float32)
            if split is None:
                ce, m = loss_lib.next_token_loss(lg, mb["tokens"])
            else:
                ce, m = loss_lib.next_token_loss_split(
                    lg, mb["tokens"], split, axis.model_group)
            loss = ce + aux
            grads = torch.autograd.grad(loss / dp, live, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:  # a leaf the loss does not reach adds 0
                a.add_((g.to(torch.float32) / microbatches).to(acc_dt))
        loss, nll = (v.detach() / dp for v in _data_sum([loss, m["nll"]],
                                                         axis))
        m = {"loss": loss, "nll": nll,
             "ppl_proxy": torch.exp(torch.clamp(nll, 0, 20.0))
             if dp > 1 else m["ppl_proxy"]}
        for k in metrics:
            metrics[k] = metrics[k] + m[k].detach() / microbatches
        del logits, lg, loss, grads, live
    return opt.tree_unflatten(params, acc), metrics


def make_train_step(model: Model, opt_cfg: opt.OptConfig,
                    microbatches: int = 1, remat=True, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics). The state it
    is given is left as it was. On a ``mesh`` the state is
    ``init_state(mesh=)``'s and ``batch`` the data rank's rows
    (``data_rows``)."""
    param_dtype = cm.DTYPES[model.cfg.dtype]
    # whether the reference stacks the layer lists (optimizer.decay_mask)
    stacked = (model.cfg.family in ("hybrid", "audio")
               or homogeneous(model.cfg))
    layout = None if mesh is None else par.Layout(model, mesh)

    def train_step(state: TrainState, batch):
        if layout is None:
            grads, metrics = loss_and_grads(
                model, state.params, batch, microbatches=microbatches,
                remat=remat, grad_accum_dtype=opt_cfg.grad_accum_dtype)
        else:
            views, metrics = loss_and_grads(
                model, opt.tree_unflatten(state.params,
                                          layout.views(state.params)),
                batch, microbatches=microbatches, remat=remat,
                grad_accum_dtype=opt_cfg.grad_accum_dtype,
                axis=layout.axis)
            grads = layout.grads(state.params, opt.tree_leaves(views))
        new_params, new_opt, opt_metrics = opt.update(
            opt_cfg, grads, state.opt, param_dtype=param_dtype,
            stacked_layers=stacked)
        metrics.update(opt_metrics)
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
