"""Shared neural-net primitives (port of ``repro/models/common.py``): dense
init, the matmul dispatch on dense or fused-VQ weights (one matrix, or an
expert stack), norms, RoPE and activations, and the sharding specs' language.

Parameter convention: plain nested dicts of tensors; dense kernels are
(in, out), as in the reference. Mixed-dtype matmuls promote like jnp
(bf16 @ f32 -> f32).

``MATMUL_DISPATCH`` is the reference's "matmul" dispatch source: one count
a call, by the weight form each matmul site met (dense or fused VQ, one
matrix or an expert stack), so a leaf densified where it should have
stayed fused shows as a count moving.

Sharding specs are the reference's: a ``P`` per parameter, one entry per
tensor dim naming the mesh axis (or tuple of axes) it is split over, or
None; a spec of None is fully replicated. ``sanitize_specs`` drops an axis
the mesh lacks or whose size does not divide the dim (the reference's rule),
and ``placements`` turns a sanitized spec into ``torch.distributed.tensor``
placements on a ``DeviceMesh`` with the same axis names.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.obs.dispatch import register_dispatch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MATMUL_DISPATCH = register_dispatch(
    "matmul", ("dense", "fused_vq", "expert_dense", "expert_fused_vq"))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# weight application: dense tensors or fused VQ leaves
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a dense (in, out) kernel or a
    ``core/vq_linear.FusedVQLinear`` (the fused VQ-dequant matmul kernel on
    CUDA; the dense weight is never materialized)."""
    from repro_torch.core import vq_linear as vql_mod

    if isinstance(w, vql_mod.FusedVQLinear):
        MATMUL_DISPATCH["fused_vq"] += 1
        return vql_mod.fused_matmul(x, w).to(x.dtype)
    MATMUL_DISPATCH["dense"] += 1
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert matmul: einsum('...ecd,edf->...ecf') for a dense (E, d, f)
    stack, or a stacked ``FusedVQLinear`` (leading E on every array)
    through the ``vq_dequant_matmul`` kernel's expert axis: one launch for
    the whole stack, the dense weights never materialized. x is (E, C, d)
    or (B, E, C, d); the result has x's dtype.

    The reference casts x to f32 before its fused expert matmul; here the
    kernel takes x as it comes. Every such x in the model is a bf16
    activation (or f32 in an f32 model), so the cast is exact and the
    bf16 tensor-core variants apply: the same products, summed in another
    order."""
    from repro_torch.core import vq_linear as vql_mod

    if not isinstance(w, vql_mod.FusedVQLinear):
        MATMUL_DISPATCH["expert_dense"] += 1
        eq = "ecd,edf->ecf" if x.dim() == 3 else "becd,edf->becf"
        return torch.einsum(eq, x, w.to(x.dtype))
    MATMUL_DISPATCH["expert_fused_vq"] += 1
    if x.dim() == 3:  # (E, C, D)
        return vql_mod.expert_fused_matmul(x, w).to(x.dtype)
    B, E, C, D = x.shape
    xt = x.transpose(0, 1).reshape(E, B * C, D)
    y = vql_mod.expert_fused_matmul(xt, w)
    return y.reshape(E, B, C, -1).transpose(0, 1).to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def position_ids(pos, batch: int, seq: int, device=None) -> torch.Tensor:
    """(B, S) absolute positions from a scalar or per-row (B,) offset."""
    p = torch.as_tensor(pos, device=device)
    if p.dim() == 0:
        p = p[None].expand(batch)
    return p[:, None] + torch.arange(seq, device=device)[None, :]


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = pos[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def act_fn(name: str):
    if name in ("swiglu", "geglu"):
        # gate nonlinearity used by gated MLPs
        return F.silu if name == "swiglu" else _gelu_tanh
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

class P(tuple):
    """The reference's ``PartitionSpec``: ``P("data", "model")`` splits
    dim 0 over the data axis and dim 1 over the model axis; ``None`` (or a
    missing trailing entry) leaves a dim whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, of a mapping of the same, or
    of anything with the reference's ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_specs(shapes, specs, mesh):
    """``specs`` with every axis dropped from a dim that the mesh lacks or
    whose size does not divide the dim (the reference's rule: GQA kv
    projections, odd vocabularies and small expert counts fall back to
    replication). ``shapes`` is a tree like ``specs`` whose leaves are
    tensors or shape tuples; dicts, lists and NamedTuples (a train
    state's) are walked."""
    size = axis_sizes(mesh)

    def fix(shape, spec):
        dims = tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape)
        if spec is None:
            return P()
        out = []
        for i, entry in enumerate(spec):
            tup = tuple(n for n in _axes(entry) if n in size)
            total = math.prod(size[n] for n in tup)
            if tup and i < len(dims) and dims[i] % total == 0:
                out.append(tup if len(tup) > 1 else tup[0])
            else:
                out.append(None)
        return P(*out)

    def walk(shapes, specs):
        if isinstance(specs, dict):
            return {k: walk(shapes[k], v) for k, v in specs.items()}
        if isinstance(specs, list):
            return [walk(a, b) for a, b in zip(shapes, specs)]
        if isinstance(specs, tuple) and hasattr(specs, "_fields"):
            return type(specs)(*(walk(a, b) for a, b in zip(shapes, specs)))
        return fix(shapes, specs)

    return walk(shapes, specs)


def placements(spec, mesh) -> list:
    """The ``torch.distributed.tensor`` placements of a sanitized spec on
    ``mesh`` (a ``DeviceMesh``): ``Shard(i)`` for each mesh dim that the
    spec names at tensor dim i, ``Replicate()`` for the others. On a
    ``("data", "model")`` mesh ``P("data", "model")`` is ``[Shard(0),
    Shard(1)]``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {n: i for i, entry in enumerate(spec or ()) for n in _axes(entry)}
    return [Shard(where[n]) if n in where else Replicate()
            for n in mesh.mesh_dim_names]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def place(t: torch.Tensor, mesh, placements):
    """``t``, the whole tensor on every rank, as a DTensor on ``mesh``:
    each rank keeps its own shard, cut locally (no collective), in storage
    of its own, so the whole tensor is freed once the caller drops it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        d = DTensor.from_local(local.clone(), mesh, placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d
