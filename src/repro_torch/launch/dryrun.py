"""Multi-node dry run on H100 terms (port of ``repro/launch/dryrun.py``):
trace one step of every (architecture x input-shape) cell on the
production meshes and record memory, operation, kernel and collective
counts for the roofline analysis.

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k [--multipod] [--vq] [--kv8] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Outputs one JSON per cell under artifacts/dryrun_torch/
(``launch/report`` renders the tables from them).

The reference lowers and compiles each cell's jitted step against a
256- or 512-device mesh; here rank 0 of a fake world of that size
(``launch/mesh.fake_production_mesh``: PyTorch's fake process group, whose
collectives return at once) runs one step on its own shards under
``FakeTensorMode``: every tensor is fake (shapes, dtypes and devices, no
storage), nothing is computed, and on ``device="cuda"`` (the default; it
needs PyTorch built for CUDA, not a card) the kernel wrappers choose
their variants as on the card and record their work (``obs/work``)
without building or launching anything. ``device="cpu"`` traces the
plain versions the CPU runs. The step runs under ``FlopCounterMode``
(aten FLOPs), a count of the kernels' and the collectives' work, and
``LiveBytes`` (live tensor bytes, the peak). A cell's record holds:

* ``argument_bytes``: the rank's state, batch and cache, by arithmetic
  from the placements; ``peak_bytes``: those plus the step's traced peak;
  ``fits``: the peak within ``HARDWARE["hbm_bytes"]`` less the reserve;
* ``flops``: the traced aten FLOPs and the kernels' counted operations
  and bytes, by kernel and variant; ``collectives``: bytes by kind and
  axis;
* ``roofline_trace_raw``: ``roofline.analyze`` on the traced counts (a
  cross-check, as the reference's ``roofline_hlo_raw``); ``roofline``:
  ``roofline.analytic_cell``, which drives the tables;
* ``gaps``: where the port's placement or trace departs from the
  reference's analytic figures, each with its reason.

Placements: a train step's state is the train step's (``models/parallel
.Layout``: the reference's specs, FSDP over ``("pod", "data")`` on a
multi-pod mesh); a serving step's parameters are what each model rank's
forward reads (``Layout.rank_params``), whole over the data axis; its
caches follow ``cache_shardings`` (the reference's policy).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import packing
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import VQConfig
from repro_torch.core.gptvq import plan_groups
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HARDWARE
from repro_torch.models import common as cm, model_zoo
from repro_torch.models import parallel as par
from repro_torch.models.parallel import widen_fsdp
from repro_torch.obs import work
from repro_torch.serve.serve_step import make_decode, make_prefill
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainState, data_rows, make_train_step

ART_DIR = os.path.join(os.path.dirname(__file__),
                       "../../../artifacts/dryrun_torch")

# serving VQ setting used for the quantized-serving dry-run variants:
# paper's 2.25 bpv (W2@g64-equivalent) 2D configuration (Table 2)
SERVE_VQ = VQConfig(d=2, bits_per_dim=2, group_size=1024, codebook_bits=8)

# the card's caching allocator hands out blocks in multiples of 512 bytes
_ALLOC_ROUND = 512


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _dpn(mesh) -> int:
    size = cm.axis_sizes(mesh)
    return math.prod(size[a] for a in dp_axes(mesh))


def batch_sharding(mesh, batch_shapes) -> dict:
    """Each batch leaf's spec: its rows over the data axes where they
    divide them."""
    dp = dp_axes(mesh)
    dp = dp[0] if len(dp) == 1 else dp
    dpn = _dpn(mesh)

    def spec(x):
        lead = dp if x.shape[0] % dpn == 0 else None
        return cm.P(lead, *([None] * (len(x.shape) - 1)))

    return {k: spec(x) for k, x in batch_shapes.items()}


# ---------------------------------------------------------------------------
# abstract inputs per cell (meta tensors: shapes and dtypes)
# ---------------------------------------------------------------------------

def abstract_batch(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> dict:
    B, S = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    if kind == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, **meta)}
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": torch.empty((B, S - n_img), dtype=torch.int32,
                                   **meta)}
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((B, n_img, cfg.d_model),
                                       dtype=torch.bfloat16, **meta)
    if cfg.family == "audio":
        batch["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, **meta)
    return batch


def abstract_cache(model, B: int, max_len: int, kv_dtype=torch.bfloat16):
    return model.init_cache(B, max_len, dtype=kv_dtype, device="meta")


def _attn_leaf(path) -> bool:
    """Whether a cache leaf at ``path`` is attention K/V (a ``KVCache``
    field or an encoder-decoder's cross K/V)."""
    return path[-1] in ("k", "v") or any(p in ("cross_k", "cross_v")
                                         for p in path)


def _map_cache(f, tree, path=()):
    """``tree`` (a cache: lists, NamedTuples, tensors) with every tensor
    leaf ``t`` replaced by ``f(path, t)``."""
    if isinstance(tree, list):
        return [_map_cache(f, v, path + (i,)) for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_cache(f, v, path + (n,))
                            for n, v in zip(tree._fields, tree)))
    return None if tree is None else f(path, tree)


def cache_shardings(model, mesh, cache_shapes, *, seq_shard=False):
    """Attention-cache sharding policy (the reference's), as sanitized
    specs on the port's cache tree (per-layer (B, S, KV, hd) K/V leaves):

    Batch shards over the DP axes. When KV divides the TP axis, heads
    shard over 'model'; otherwise (GQA with kv < tp) the *sequence* shards
    over 'model' — flash-decode style: each rank attends over its cache
    slice and the ranks merge the softmax's max, sum and weighted values
    (``parallel.merge_softmax``). For batch=1 long-context cells the
    sequence additionally takes the 'data' axis. Recurrent state (xLSTM)
    shards its batch over the DP axes; the hybrid's follow its
    ``cache_specs(seq_shard=)``."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        specs = widen_fsdp(model.cache_specs(seq_shard=seq_shard), mesh)
        return cm.sanitize_specs(cache_shapes, specs, mesh)
    tp = cm.axis_sizes(mesh).get("model", 1)
    dp = dp_axes(mesh)
    dpn = _dpn(mesh)

    def kv_policy(path, leaf):
        dims = tuple(leaf.shape)
        if not _attn_leaf(path):  # recurrent state: batch-first leaves
            lead = dp if dims and dims[0] % dpn == 0 else None
            return cm.P(lead, *([None] * (len(dims) - 1)))
        B, S, KV, hd = dims
        batch_ax = dp if B % dpn == 0 else None
        if B == 1:
            # single-sequence long context: seq over data AND model
            return cm.P(None, ("data", "model"), None, None)
        if KV % tp == 0:
            return cm.P(batch_ax, None, "model", None)
        return cm.P(batch_ax, "model", None, None)

    specs = _map_cache(kv_policy, cache_shapes)
    return cm.sanitize_specs(cache_shapes, specs, mesh)


def port_cache_specs(cfg: ModelConfig, specs) -> tuple:
    """The placements the port's serving step holds its cache in: the
    policy's (``cache_shardings``) except where the port's layer reads a
    leaf whole on every model rank. Returns (specs, gaps): the hybrid's
    Mamba state (the reference splits h's heads and conv's channels over
    'model'; a serving step's mixer carries its state and runs whole,
    ``ssm.pre_out``) and an encoder-decoder's cross K/V along the
    sequence (its cross-attention reads them whole, ``encdec
    ._cross_attend``) stay whole over those axes."""
    gaps = set()

    def fix(path, spec):
        if cfg.family == "hybrid" and "mamba" in path:
            if any("model" in cm._axes(e) for e in spec):
                gaps.add("hybrid Mamba state whole over 'model': the "
                         "reference splits h's heads and conv's channels; "
                         "the port's mixer with a cache runs whole")
            return cm.P(*(None if "model" in cm._axes(e) else e
                          for e in spec))
        if any(p in ("cross_k", "cross_v") for p in path) and len(spec) > 1 \
                and spec[1] is not None:
            gaps.add("cross K/V whole along the sequence: the port's "
                     "cross-attention reads them whole")
            return cm.P(spec[0], None, *spec[2:])
        return spec

    return _map_cache(fix, specs), sorted(gaps)


def kv_spec(specs):
    """The spec of the first attention K leaf of a cache spec tree (None
    for a model without attention)."""
    found = []

    def keep(path, spec):
        if path[-1] == "k":
            found.append(spec)
        return spec

    _map_cache(keep, specs)
    return found[0] if found else None


# ---------------------------------------------------------------------------
# VQ-compressed abstract parameters (quantized-serving variants)
# ---------------------------------------------------------------------------

_VQ_TARGET_KEYS = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "up",
                   "up_gate", "down", "in_proj", "out_proj", "w_z", "w_i",
                   "w_f", "w_o")


def _walk_paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _walk_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _walk_paths(v, path + (i,))]
    return [(path, tree)]


def vq_abstract_params(model, vq_cfg: VQConfig):
    """Replace weight leaves with abstract ``VQLinear`` leaves of meta
    tensors (+ their specs, ``VQLinear`` trees of ``common.P``); the other
    f32 leaves become bf16."""
    shapes = model_zoo.abstract_params(model)
    specs = model.param_specs()
    flat = _walk_paths(shapes)
    spec_leaves = opt.tree_leaves(specs)

    def convert(path, leaf, spec):
        keys = [str(k) for k in path]
        name = keys[-1] if keys else ""
        inside_layers = any(k in ("layers", "mamba", "enc_layers",
                                  "dec_layers", "shared") for k in keys)
        if (name not in _VQ_TARGET_KEYS or not inside_layers
                or leaf.dim() < 2 or leaf.shape[-1] < 64
                or leaf.shape[-2] < 64):
            if leaf.dtype == torch.float32:
                leaf = torch.empty(leaf.shape, dtype=torch.bfloat16,
                                   device="meta")
            return leaf, spec
        lead = tuple(leaf.shape[:-2])
        d_in, d_out = leaf.shape[-2], leaf.shape[-1]
        r, c = d_out, d_in  # VQ layout is (out, in)
        cg, rg = plan_groups(r, c, vq_cfg)
        n_cg, n_bands = c // cg, r // rg
        code_bits = max(1, (vq_cfg.k - 1).bit_length())
        lanes = 32 // packing.container_bits(code_bits)
        words = (c // vq_cfg.d) // lanes

        def sds(shape, dt):
            return torch.empty((*lead, *shape), dtype=dt, device="meta")

        static = dict(r=r, c=c, d=vq_cfg.d, k=vq_cfg.k, group_cols=cg,
                      rows_per_band=rg, scale_block=0)
        leaf_q = vql.VQLinear(
            words=sds((r, words), torch.int32),
            codebooks=sds((n_cg, n_bands, vq_cfg.k, vq_cfg.d), torch.int8),
            cb_scale=sds((n_cg, n_bands), torch.float32),
            scale_sint=sds((n_cg, r, 1), torch.int8),
            scale_a=sds((n_cg,), torch.float32),
            scale_z=sds((n_cg,), torch.float32), **static)
        # shardings: rows (out) follow the original out axis, column groups
        # follow the original in axis
        nlead = len(lead)
        spec = tuple(spec or ())
        in_ax = spec[-2] if len(spec) >= 2 else None
        out_ax = spec[-1] if len(spec) >= 1 else None
        lead_sp = (list(spec[:nlead]) if len(spec) >= nlead + 2
                   else [None] * nlead)
        P = cm.P
        spec_q = vql.VQLinear(
            words=P(*lead_sp, out_ax, in_ax),
            codebooks=P(*lead_sp, in_ax, out_ax, None, None),
            cb_scale=P(*lead_sp, in_ax, out_ax),
            scale_sint=P(*lead_sp, in_ax, out_ax, None),
            scale_a=P(*lead_sp, in_ax), scale_z=P(*lead_sp, in_ax),
            **static)
        return leaf_q, spec_q

    out = [convert(path, leaf, spec)
           for (path, leaf), spec in zip(flat, spec_leaves)]
    return (opt.tree_unflatten(shapes, [o[0] for o in out]),
            opt.tree_unflatten(shapes, [o[1] for o in out]))


def _vq_arrays(leaf) -> list:
    return [getattr(leaf, f.name) for f in dataclasses.fields(leaf)
            if isinstance(getattr(leaf, f.name), torch.Tensor)]


def vq_param_bytes(shapes) -> int:
    total = 0
    for leaf in opt.tree_leaves(shapes):
        arrays = (_vq_arrays(leaf) if isinstance(leaf, vql.VQLinear)
                  else [leaf])
        total += sum(math.prod(a.shape) * a.element_size() for a in arrays)
    return total


# ---------------------------------------------------------------------------
# per-cell builders
# ---------------------------------------------------------------------------

def active_param_counts(model) -> tuple[int, int]:
    """(total_non_embed, active_non_embed) for MODEL_FLOPS: an expert
    stack (E, in, out) counts its top-k share as active."""
    cfg = model.cfg
    total = active = 0
    for path, leaf in _walk_paths(model_zoo.abstract_params(model)):
        keys = [str(k) for k in path]
        n = math.prod(leaf.shape)
        if "embed" in keys or "pos_enc" in keys or "pos_dec" in keys:
            continue
        total += n
        if cfg.family == "moe" and "ffn" in keys and leaf.dim() == 3:
            active += n * cfg.n_experts_active // cfg.n_experts
        else:
            active += n
    return total, active


def plan_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    per_dev = max(1, shape.global_batch // _dpn(mesh))
    # target one sequence per device per microbatch for >=7B models
    big = cfg.d_model >= 3000 or cfg.n_layers >= 40
    return per_dev if big else max(1, per_dev // 4)


def model_flops(kind: str, n_active: int, shape: ShapeConfig) -> tuple:
    """(the reference's MODEL_FLOPS of a cell, its note)."""
    tokens = shape.global_batch * shape.seq_len
    if kind == "train":
        return (rl.model_flops_train(n_active, tokens) * 1.33,
                "6*N_active*tokens * 1.33 remat")
    if kind == "prefill":
        return (rl.model_flops_train(n_active, tokens) / 3.0,
                "2*N_active*tokens (fwd only)")
    return (rl.model_flops_decode(n_active, shape.global_batch),
            "2*N_active*batch (per token)")


def cell_id(arch: str, shape_name: str, multi_pod: bool, vq: bool = False,
            kv8: bool = False) -> str:
    return f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}" + (
        "__vq" if vq else "") + ("__kv8" if kv8 else "")


class LiveBytes(TorchDispatchMode):
    """Live tensor bytes through a block: every storage an op makes is
    counted (rounded up to the caching allocator's 512 bytes) until it is
    freed, the storages of ``args`` (live before the block: an op's view
    or in-place output of an argument) excepted; ``peak`` is the most at
    once. Also sums each op's bytes accessed (its tensor inputs read and
    outputs written; views and allocations move none), ``accessed``."""

    _SKIP = ("empty", "empty_like", "empty_strided", "zeros", "ones",
             "full", "zeros_like", "ones_like", "full_like", "arange")

    def __init__(self, args=()):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._refs: dict = {}
        # the arguments' storages: live before the block, never counted
        self._args = {_local(t).untyped_storage()._cdata
                      for t in _leaves_all(args)}

    def _storages(self, t):
        if hasattr(t, "_local_tensor"):  # a DTensor: its shard's storage
            t = t._local_tensor
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            yield t.untyped_storage()

    def _drop(self, key, nbytes):
        self._refs.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat_out = _tensors(out)
        for t in flat_out:
            for st in self._storages(t):
                key = st._cdata
                if key in self._refs or key in self._args:
                    continue
                n = -(-st.nbytes() // _ALLOC_ROUND) * _ALLOC_ROUND
                self._refs[key] = weakref.ref(
                    st, lambda _r, k=key, n=n: self._drop(k, n))
                self.live += n
        self.peak = max(self.peak, self.live)
        name = func.__name__.split(".")[0]
        if not getattr(func, "is_view", False) and name not in self._SKIP:
            self.accessed += sum(work.nbytes(_local(t)) for t in
                                 _tensors((args, kwargs)) + flat_out)
        return out


def _local(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _arg_bytes(tree) -> int:
    """The bytes of a tree's tensors (a DTensor's shard; a VQ leaf's
    arrays), each storage once."""
    seen, total = set(), 0
    for leaf in _leaves_all(tree):
        t = _local(leaf)
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _leaves_all(tree) -> list:
    if isinstance(tree, (vql.VQLinear, vql.FusedVQLinear)):
        return _vq_arrays(tree)
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_all(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_all(v)]
    return []


def _fake_tree(tree, dev):
    """A tree of meta tensors (and VQ leaves of them) as empty tensors on
    ``dev`` (fake ones under ``FakeTensorMode``)."""
    if isinstance(tree, vql.VQLinear):
        kw = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
        for f in dataclasses.fields(tree):
            if isinstance(kw[f.name], torch.Tensor):
                kw[f.name] = torch.empty_like(kw[f.name], device=dev)
        return vql.VQLinear(**kw)
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device=dev)
    if isinstance(tree, dict):
        return {k: _fake_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_tree(v, dev) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_fake_tree(v, dev) for v in tree))
    return tree


def fake_of(tree, mode):
    """``tree`` (tensors, ``VQLinear`` / ``FusedVQLinear`` leaves, dicts,
    lists, NamedTuples) with every tensor a fake of it in ``mode`` (its
    shape, dtype, device, strides and storage offset)."""
    if isinstance(tree, (vql.VQLinear, vql.FusedVQLinear)):
        kw = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
              if f.init}
        kw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
        return type(tree)(**kw)
    if isinstance(tree, torch.Tensor):
        return mode.from_tensor(tree)
    if isinstance(tree, dict):
        return {k: fake_of(v, mode) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fake_of(v, mode) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(fake_of(v, mode) for v in tree))
    return tree


def _dtensor_state(layout, whole):
    """The rank's DTensors of ``whole`` (fake tensors) by ``layout``'s
    placements: its shards, cut locally (``parallel.local_part``)."""
    from torch.distributed.tensor import DTensor

    leaves = []
    for p, leaf in zip(opt.tree_leaves(whole), layout.of(whole)):
        spec = _spec_of(leaf, layout.mesh)
        local = par.local_part(p, spec, layout.mesh)
        leaves.append(DTensor.from_local(
            local, layout.mesh, leaf.placements, run_check=False,
            shape=p.shape, stride=p.stride()))
    return opt.tree_unflatten(whole, leaves)


def _spec_of(leaf, mesh):
    """A ``Layout`` leaf's placements as a spec (the inverse of
    ``common.placements``)."""
    dims: dict = {}
    for name, pl in zip(mesh.mesh_dim_names, leaf.placements):
        if pl.is_shard():
            dims.setdefault(pl.dim, []).append(name)
    n = max(dims, default=-1) + 1
    return cm.P(*(None if i not in dims else (
        dims[i][0] if len(dims[i]) == 1 else tuple(dims[i]))
        for i in range(n)))


@dataclasses.dataclass
class Cell:
    """A built cell: ``step()`` runs the traced step on ``args``."""
    meta: dict
    mesh: object
    axis: object
    step: object
    args: tuple
    gaps: list


def build_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               vq: bool = False, kv8: bool = False, device: str = "cuda",
               cfg: ModelConfig | None = None,
               shape: ShapeConfig | None = None, mesh=None,
               vq_cfg: VQConfig = SERVE_VQ, microbatches: int | None = None,
               opt_cfg: opt.OptConfig | None = None,
               sources: dict | None = None) -> Cell:
    """The cell's mesh (the production mesh unless ``mesh`` is given),
    model, rank-0 state, batch and cache, and its step; call inside
    ``FakeTensorMode`` (the tensors are made on ``device``) with a
    ``mesh`` built outside it. ``cfg`` and
    ``shape`` replace the arch's config and the named shape, ``vq_cfg``
    the serving VQ setting, ``microbatches`` and ``opt_cfg`` the train
    step's plan (a smaller cell, or a card phase's own configuration).
    ``sources`` ({"params", "batch", "cache"}, any of them) gives whole
    tensors on ``device`` (real ones to run the cell on the card, or fake
    ones from real: ``fake_of``) in place of the empty ones made from the
    shapes."""
    sources = sources or {}

    def source(key, meta_tree):
        return sources[key] if key in sources else _fake_tree(meta_tree,
                                                              device)

    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = mesh_lib.fake_production_mesh(multi_pod=multi_pod,
                                             device_type=device)
    model = model_zoo.build(cfg)
    total_p, active_p = active_param_counts(model)
    size = cm.axis_sizes(mesh)
    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "multi_pod": multi_pod, "vq": vq, "device": device,
        "chips": int(math.prod(size.values())),
        "mesh": dict(size),
        "params_total": total_p, "params_active": active_p,
    }
    gaps: list = []
    if shape.kind == "train":
        assert not vq
        # >=30B models store Adam moments in bf16 (the reference's rule)
        big = cfg.d_model * cfg.n_layers >= 8192 * 24 or cfg.family == "moe"
        ocfg = opt_cfg or opt.OptConfig(
            moment_dtype="bfloat16" if big else "float32",
            grad_accum_dtype="bfloat16" if big else "float32")
        mb = microbatches or plan_microbatches(cfg, shape, mesh)
        meta.update(moment_dtype=ocfg.moment_dtype, microbatches=mb)
        layout = par.Layout(model, mesh)
        params = _dtensor_state(layout, source(
            "params", model_zoo.abstract_params(model)))
        state = TrainState(params=params, opt=opt.init(params, ocfg))
        batch = data_rows(source("batch", abstract_batch(cfg, shape,
                                                         "train")), mesh, mb)
        fn = make_train_step(model, ocfg, microbatches=mb, mesh=mesh)
        cell = Cell(meta, mesh, layout.axis, fn, (state, batch), gaps)
    else:
        if vq:
            pshapes, _ = vq_abstract_params(model, vq_cfg)
        else:
            pshapes = opt.tree_unflatten(model_zoo.abstract_params(model), [
                torch.empty(s.shape, dtype=torch.bfloat16, device="meta")
                if s.dtype == torch.float32 and s.dim() >= 1 else s
                for s in opt.tree_leaves(model_zoo.abstract_params(model))])
        max_len = shape.seq_len
        kv_dtype = torch.float8_e4m3fn if kv8 else torch.bfloat16
        meta["kv_dtype"] = "fp8" if kv8 else "bf16"
        cache_shapes = abstract_cache(model, shape.global_batch, max_len,
                                      kv_dtype)
        seq_shard = shape.name == "long_500k" or (
            shape.kind == "decode" and shape.global_batch < _dpn(mesh))
        specs = cache_shardings(model, mesh, cache_shapes,
                                seq_shard=seq_shard)
        meta["seq_sharded_cache"] = bool(seq_shard)
        port_specs, cache_gaps = port_cache_specs(cfg, specs)
        gaps += cache_gaps
        axis = par.serve_axis(mesh, kv_spec(port_specs) or cm.P())
        layout = par.Layout(model, mesh, axis=axis)
        params = source("params", pshapes)
        if vq:
            meta["vq_param_bytes"] = vq_param_bytes(params)
            params = vql.prepare_fused_tree(params)
        params = layout.rank_params(params)
        if any(getattr(p, "in_window", None) is not None
               for p in opt.tree_leaves(params)):
            gaps.append("VQ leaves whose column groups do not split over "
                        "'model' are held whole; the rank meets them with "
                        "its columns of the input, zero-padded (the matmul "
                        "at the whole width)")
        cache = par.rank_tree(source("cache", cache_shapes), port_specs,
                              mesh)
        if shape.kind == "prefill":
            batch = par.rank_rows(source(
                "batch", abstract_batch(cfg, shape, "prefill")), axis)
            fn = make_prefill(model, last_only=True, axis=axis)
            args = (params, batch, cache)
        else:  # decode: one token at the last position of the cache
            tokens = par.rank_rows(source(
                "batch", abstract_batch(cfg, shape, "decode")), axis)["tokens"]
            fn = make_decode(model, axis=axis)
            args = (params, tokens, cache, max_len - 1)
        if axis.tp > 1 and axis.cache.seq_group is not None \
                and not cfg.attention_free:
            gaps.append("sequence-split cache: attention's projections "
                        "run whole on every model rank (replicated, not "
                        "split over 'model' as the analytic model takes "
                        "them)")
        if not vq:
            gaps.append("serving weights whole over the data axis (the "
                        "reference shards them over data as well and "
                        "gathers them each step)")
        cell = Cell(meta, mesh, axis, fn, args, gaps)
    flops, meta["model_flops_note"] = model_flops(shape.kind, active_p, shape)
    meta["model_flops"] = float(flops)
    return cell


def trace(cell: Cell) -> dict:
    """Run ``cell``'s step once under the counters (inside the
    ``FakeTensorMode`` it was built in, or on real tensors): the aten
    FLOPs, the kernels' and collectives' count, the live-bytes peak above
    the arguments and the bytes accessed."""
    from torch.utils.flop_counter import FlopCounterMode

    flop_mode = FlopCounterMode(display=False)
    gc.collect()
    live = LiveBytes(cell.args)
    with work.counting(_axes_of(cell)) as count, flop_mode, live, _no_gc():
        cell.step(*cell.args)
    aten = float(flop_mode.get_total_flops())
    return {"aten_flops": aten, "kernel_flops": count.kernel_flops(),
            "flops": aten + count.kernel_flops(),
            "kernel_bytes": count.kernel_bytes(),
            "aten_bytes_accessed": float(live.accessed),
            "peak_step_bytes": int(live.peak), "work": count.as_dict(),
            "launches": count.launches()}


@contextlib.contextmanager
def _no_gc():
    """The garbage collector off for a step: a step leaves some of its
    tensors in reference cycles, freed when the collector runs, so with it
    off the trace and the card free at the same points (a reference
    count's); ``trace`` and ``measure`` collect before it."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _axes_of(cell: Cell) -> dict:
    axes = {cell.mesh.get_group(n): ("model" if n == "model" else "data")
            for n in cell.mesh.mesh_dim_names}
    axes.update(cell.axis.groups())
    return axes


def measure(cell: Cell) -> dict:
    """Run a cell built on real tensors (``build_cell(sources=)``) as the
    trace runs it: once to warm up (the first call's one-time allocations,
    e.g. cuBLAS's workspace), once timed with no counter on, once under
    ``FlopCounterMode`` with the kernels' count active, and once more
    under ``LiveBytes``. Returns the aten and kernel FLOPs, the launches
    by kernel and variant (of the counted run), the timed run's seconds,
    the live-bytes peak and, on the card, the peak: the arguments' bytes
    plus ``torch.cuda.max_memory_allocated`` above what was allocated
    before the counted run."""
    from torch.utils.flop_counter import FlopCounterMode

    cuda = any(t.is_cuda for t in _leaves_all(cell.args))
    out = cell.step(*cell.args)
    del out
    gc.collect()  # the warm-up's garbage (its state is held in cycles)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _no_gc():
        out = cell.step(*cell.args)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del out
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    flop_mode = FlopCounterMode(display=False)
    with work.counting(_axes_of(cell)) as count, flop_mode, _no_gc():
        out = cell.step(*cell.args)
    if cuda:
        torch.cuda.synchronize()
        mem = {"base_bytes": base,
               "allocated_after_bytes": torch.cuda.memory_allocated(),
               "max_allocated_bytes": torch.cuda.max_memory_allocated()}
    del out
    # the same step under the trace's live-bytes count, on real tensors
    gc.collect()
    live = LiveBytes(cell.args)
    with live, _no_gc():
        out = cell.step(*cell.args)
    res = {"aten_flops": float(flop_mode.get_total_flops()),
           "kernel_flops": count.kernel_flops(), "seconds": secs,
           "launches": count.launches(),
           "argument_bytes": _arg_bytes(cell.args)}
    res["flops"] = res["aten_flops"] + res["kernel_flops"]
    res["live_peak_step_bytes"] = int(live.peak)
    if cuda:
        res.update(mem, peak_bytes=res["argument_bytes"]
                   + mem["max_allocated_bytes"] - base)
    del out
    return res


# the token counts a stepwise (xLSTM train or prefill) cell is traced at
STEPWISE_TOKENS = (16, 32)


def _traced(arch, shape_name, shape, *, multi_pod, vq, kv8, device, cfg,
            mesh_shape, vq_cfg, microbatches, opt_cfg, sources):
    """One cell built and traced on a fake world of its own (closed
    before it returns): (meta, gaps, argument bytes, ``trace``'s counts,
    build seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    mesh = (mesh_lib.fake_mesh(*mesh_shape, device_type=device)
            if mesh_shape else mesh_lib.fake_production_mesh(
                multi_pod=multi_pod, device_type=device))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        cell = build_cell(
            arch, shape_name, multi_pod=multi_pod, vq=vq, kv8=kv8,
            device=device, cfg=cfg, shape=shape, mesh=mesh, vq_cfg=vq_cfg,
            microbatches=microbatches, opt_cfg=opt_cfg,
            sources=None if sources is None else fake_of(sources, mode))
        arg_bytes = _arg_bytes(cell.args)
        t_build = time.time() - t0
        counts = trace(cell)
    out = (cell.meta, cell.gaps, arg_bytes, counts, t_build)
    del cell, mesh
    mesh_lib.close_world()
    return out


def _affine(a, b, t):
    """``a + (b - a) * t`` over every number of two like trees (dicts,
    lists, tuples; ints stay ints; other leaves ``a``'s)."""
    if isinstance(a, dict):
        return {k: _affine(a[k], b[k], t) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_affine(x, y, t) for x, y in zip(a, b))
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return a
    v = a + (b - a) * t
    return int(round(v)) if isinstance(a, int) else float(v)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             vq: bool = False, kv8: bool = False, save: bool = True,
             device: str = "cuda", cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None, mesh_shape=None,
             vq_cfg: VQConfig = SERVE_VQ, microbatches: int | None = None,
             opt_cfg: opt.OptConfig | None = None,
             sources: dict | None = None, out_dir: str = ART_DIR) -> dict:
    """One cell's record (see the module docstring); ``mesh_shape`` a
    ((sizes), (axis names)) pair in place of the production mesh (the
    tests' smaller fake world); ``vq_cfg``, ``microbatches``, ``opt_cfg``
    as ``build_cell``'s, and ``sources`` real whole tensors whose fakes
    (``fake_of``) the cell is built from. The fake world is closed before
    it returns."""
    cfg_ = cfg or ARCHS[arch]
    shape_ = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg_, shape_)
    cid = cell_id(arch, shape_name, multi_pod, vq, kv8)
    if not ok:
        result = {"cell": cid, "status": "skipped", "reason": reason}
        if save:
            _save(cid, result, out_dir)
        return result
    if vq and shape_.kind == "train":
        return {"cell": cid, "status": "skipped", "reason": "vq is serve-only"}
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise ValueError("the dry run on device='cuda' needs PyTorch built "
                         "for CUDA (no card is touched); device='cpu' "
                         "traces the plain versions")
    kw = dict(multi_pod=multi_pod, vq=vq, kv8=kv8, device=device, cfg=cfg,
              mesh_shape=mesh_shape, vq_cfg=vq_cfg,
              microbatches=microbatches, opt_cfg=opt_cfg, sources=sources)
    t0 = time.time()
    try:
        if cfg_.family == "ssm" and shape_.kind != "decode" \
                and shape_.seq_len > STEPWISE_TOKENS[-1]:
            # the xLSTM's recurrences step token by token: the same ops a
            # token, so every count is affine in the tokens; trace two
            # lengths and extend
            s1, s2 = STEPWISE_TOKENS
            a, b = (_traced(arch, shape_name, ShapeConfig(
                shape_.name, n, shape_.global_batch, shape_.kind), **kw)
                for n in (s1, s2))
            meta, gaps, arg_bytes, counts, _ = _affine(
                a, b, (shape_.seq_len - s1) / (s2 - s1))
            t_build = a[-1] + b[-1]
            meta["stepwise_traced_tokens"] = [s1, s2]
            flops, meta["model_flops_note"] = model_flops(
                shape_.kind, meta["params_active"], shape_)
            meta["model_flops"] = float(flops)
            gaps.append(
                f"traced at {s1} and {s2} tokens and extended to "
                f"{shape_.seq_len}: the xLSTM's recurrences run the same "
                "ops a token, so FLOPs, collective and argument bytes and "
                "the peak are affine in the tokens (exactly, checked at 8, "
                "16 and 24), the aten bytes accessed nearly (within 1%); a "
                "token-by-token trace of this length takes hours")
        else:
            meta, gaps, arg_bytes, counts, t_build = _traced(
                arch, shape_name, shape_, **kw)
    except Exception as e:  # a failed cell is a bug — surface it loudly
        mesh_lib.close_world()
        result = {"cell": cid, "status": "FAILED", "error": repr(e)[:2000]}
        if save:
            _save(cid, result, out_dir)
        return result
    size = meta["mesh"]
    dp = math.prod(v for k, v in size.items() if k != "model")
    tp = size.get("model", 1)
    t_trace = time.time() - t0 - t_build
    # embedding params (bf16 even under VQ) included in the weight payload
    emb = cfg_.padded_vocab * cfg_.d_model * (
        1 if cfg_.tie_embeddings else 2)
    payload = (meta["vq_param_bytes"] if vq and "vq_param_bytes" in meta
               else (meta["params_total"] + emb) * 2)
    analytic = rl.analytic_cell(
        cfg_, shape_, chips=meta["chips"], dp=dp, tp=tp,
        n_total=meta["params_total"], n_active=meta["params_active"],
        microbatches=meta.get("microbatches", 1),
        weight_payload_bytes=payload, kv_bytes=1.0 if kv8 else 2.0)
    coll = counts["work"]["collectives"]
    by_axis = {"model": 0, "data": 0}
    for kind, axes in coll.items():
        if kind == "total":
            continue
        for axis_name, b in axes.items():
            by_axis["model" if axis_name == "model" else "data"] += b
    raw = rl.analyze(
        {"flops": counts["flops"],
         "bytes accessed": counts["aten_bytes_accessed"]
         + counts["kernel_bytes"]},
        {**by_axis, "total": coll["total"]}, chips=meta["chips"],
        model_flops=meta["model_flops"])
    peak = arg_bytes + counts["peak_step_bytes"]
    budget = HARDWARE["hbm_bytes"] - HARDWARE["hbm_reserve"]
    result = {
        "cell": cid, "status": "ok", **meta,
        "build_s": round(t_build, 2), "trace_s": round(t_trace, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "peak_step_bytes": counts["peak_step_bytes"],
                   "peak_bytes": peak, "budget_bytes": budget},
        "fits": bool(peak <= budget),
        "flops": {"aten": counts["aten_flops"],
                  "kernels": counts["kernel_flops"],
                  "total": counts["flops"],
                  "kernel_bytes": counts["kernel_bytes"],
                  "aten_bytes_accessed": counts["aten_bytes_accessed"]},
        "kernels": counts["work"]["kernels"],
        "launches": counts["launches"],
        "collectives": coll, "collectives_by_axis": by_axis,
        "roofline_trace_raw": raw.as_dict(),
        "roofline": analytic, "gaps": gaps,
    }
    if save:
        _save(cid, result, out_dir)
    return result


def _save(cid: str, result: dict, out_dir: str = ART_DIR):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cid + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=str)


def all_cells(vq_variants: bool = True):
    cells = []
    for arch in ARCHS:
        if arch == "llama2-7b":
            continue
        for shape in SHAPES:
            for mp in (False, True):
                cells.append((arch, shape, mp, False))
            if vq_variants and SHAPES[shape].kind == "decode":
                cells.append((arch, shape, False, True))
    return cells


def _grid_cost(cell) -> float:
    """A cell's rough tracing cost, to start the longest first: layers,
    three passes for a train step, and for the xLSTM's time loops (its
    recurrences step token by token) the tokens."""
    arch, shape, _, _ = cell
    cfg, sh = ARCHS[arch], SHAPES[shape]
    cost = {"train": 3.0, "prefill": 1.0, "decode": 0.05}[sh.kind] * (
        cfg.n_layers + cfg.n_encoder_layers)
    if cfg.family == "ssm" and sh.kind != "decode":
        cost *= sh.seq_len / 64
    return cost


def _grid_cell(cell, device: str, out_dir: str):
    arch, shape, mp, vq = cell
    t0 = time.time()
    r = run_cell(arch, shape, multi_pod=mp, vq=vq, device=device,
                 out_dir=out_dir)
    return r, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--vq", action="store_true")
    ap.add_argument("--kv8", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="trace the card's path (needs PyTorch built for "
                    "CUDA, not a card) or the CPU's plain versions")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once, one process "
                    "each")
    args = ap.parse_args(argv)

    if args.all:
        import concurrent.futures
        import multiprocessing

        t_all = time.time()
        cells = sorted(all_cells(), key=_grid_cost, reverse=True)
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            futs = {pool.submit(_grid_cell, c, args.device, args.out): c
                    for c in cells}
            for fut in concurrent.futures.as_completed(futs):
                arch, shape, mp, vq = futs[fut]
                r, secs = fut.result()
                cid = (f"{arch}/{shape}/{'pod2' if mp else 'pod1'}"
                       f"{'/vq' if vq else ''}")
                print(f"[{time.strftime('%H:%M:%S')}] {cid}: {r['status']} "
                      f"({secs:.0f}s) "
                      + (r.get("reason", r.get("error", ""))
                         if r["status"] != "ok" else
                         f"dom={r['roofline']['dominant']} fits={r['fits']}"),
                      flush=True)
        print(f"grid: {len(cells)} cells in {time.time() - t_all:.1f}s "
              f"with {args.jobs} process(es)", flush=True)
        return
    r = run_cell(args.arch, args.shape, multi_pod=args.multipod, vq=args.vq,
                 kv8=args.kv8, device=args.device, out_dir=args.out)
    print(json.dumps(r, indent=2, default=str))


if __name__ == "__main__":
    main()
