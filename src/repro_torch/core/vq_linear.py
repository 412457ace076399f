"""VQ-compressed linear layers: the serving-side representation (port of
``repro/core/vq_linear.py``).

A quantized linear stores, per weight matrix W (r=out, c=in):

  * ``words``      — bit-packed centroid indices (int32 holding the
                     reference's uint32 bit patterns), ``c/d`` codes per row,
                     packed row-major: (r, words per row) when rows fill
                     whole words, else one flat run (1, n_words).
  * ``codebooks``  — int8 centroids (n_cg, n_bands, k, d) + per-codebook
                     fp32 scale (n_cg, n_bands).
  * ``scale_sint`` — optional 4-bit log-domain blockwise normalization codes
                     (stored as int8; 2 codes/byte in the bpv math).

Two execution forms:
  * gather — ``dequant_tree`` densifies ``VQLinear`` leaves per layer inside
    the model forward (``models/transformer._block_apply``).
  * fused  — ``prepare_fused_tree`` turns ``VQLinear`` leaves into
    ``FusedVQLinear`` once (cb_scale folded into f32 codebooks, which the
    plain version and the reference's contract read; the int8 codebooks
    and cb_scale kept beside them for the kernel's split-K and int8
    tensor-core variants; the normalization plane pre-expanded to
    (r, c / scale_block)); every model
    matmul site (``models/common.matmul``) then calls ``fused_matmul``, which
    is the ``vq_dequant_matmul`` kernel on CUDA for every packing layout:
    the dense weight is never materialized in device memory. On the CPU the
    kernel's plain version runs instead, and ``dequantize`` shares its
    decode (``kernels/vq_dequant_matmul.reconstruct``).

A mixture-of-experts layer stacks its experts' leaves: every array of a
``VQLinear`` / ``FusedVQLinear`` carries a leading E (the reference's
``jax.tree.map(jnp.stack)``), the static fields are one expert's.
``dequantize`` and ``dequant_tree`` map over the stack (the gather form);
``prepare_fused`` makes one grouped ``vq_dequant_matmul`` input for it,
which ``expert_fused_matmul`` (``models/common.expert_matmul``) runs in
one launch. ``fused_matmul`` refuses a stacked leaf, as the reference
does.

``COUNTS`` is the "vq" dispatch counter (registered with ``obs.dispatch``):
"gather" counts leaves densified by ``dequant_tree``, "fused" counts
``fused_matmul`` calls. ``retag`` picks the form for a whole tree.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing
from repro_torch.core.bpv import VQConfig
from repro_torch.core.gptvq import VQResult
from repro_torch.kernels import vq_dequant_matmul as vqdm
from repro_torch.obs.dispatch import register_dispatch

VQ_IMPLS = ("gather", "fused")
COUNTS = register_dispatch("vq", VQ_IMPLS)


def _code_bits(k: int) -> int:
    return max(1, (k - 1).bit_length())


@dataclasses.dataclass
class VQLinear:
    """One VQ-compressed weight matrix."""

    words: torch.Tensor       # (r, c/d*cbits/32) or (1, r*c/d*cbits/32) int32
    codebooks: torch.Tensor   # (n_cg, n_bands, k, d) int8
    cb_scale: torch.Tensor    # (n_cg, n_bands) f32
    scale_sint: torch.Tensor  # (n_cg, r, cg/Ns) int8 (zeros if normalization off)
    scale_a: torch.Tensor     # (n_cg,) f32
    scale_z: torch.Tensor     # (n_cg,) f32
    r: int = 0
    c: int = 0
    d: int = 1
    k: int = 2
    group_cols: int = 256
    rows_per_band: int = 1
    scale_block: int = 0
    rule: str = ""            # recipe provenance of this leaf

    @property
    def code_bits(self) -> int:
        return _code_bits(self.k)

    @property
    def n_cg(self) -> int:
        return self.c // self.group_cols

    @property
    def n_bands(self) -> int:
        return self.r // self.rows_per_band


def from_vq_result(res: VQResult) -> VQLinear:
    """Pack a quantizer output into the serving format."""
    cfg = res.cfg
    idx = res.arrays.indices  # (r, c/d)
    code_bits = _code_bits(cfg.k)
    lanes = 32 // packing.container_bits(code_bits)
    r, nspans = idx.shape
    # row-major either way; rows that straddle words stay one flat run
    words = packing.pack(idx, code_bits).reshape(
        r if nspans % lanes == 0 else 1, -1)

    C = res.arrays.codebooks
    if res.codebook_scale is not None:
        s = res.codebook_scale
    else:
        qmax = 2 ** (cfg.codebook_bits - 1) - 1
        absmax = C.abs().amax(dim=(2, 3))
        s = torch.where(absmax == 0, torch.ones_like(absmax), absmax / qmax)
    Cq = torch.clamp(torch.round(C / s[..., None, None]), -128, 127).to(torch.int8)

    return VQLinear(
        words=words, codebooks=Cq, cb_scale=s.to(torch.float32),
        scale_sint=res.arrays.scale_sint.to(torch.int8),
        scale_a=res.arrays.scale_a, scale_z=res.arrays.scale_z,
        r=res.r, c=res.c, d=cfg.d, k=cfg.k, group_cols=res.group_cols,
        rows_per_band=res.rows_per_band, scale_block=cfg.scale_block)


def unpack_indices(vql: VQLinear) -> torch.Tensor:
    """(r, c/d) int32 codes from the packed words."""
    nspans = vql.c // vql.d
    return packing.unpack(vql.words, vql.code_bits,
                          vql.r * nspans).reshape(vql.r, nspans)


def _scale_plane(scale_a, scale_sint, scale_z, r: int, c: int,
                 scale_block: int) -> torch.Tensor:
    """exp2(a*sint + z) as an (r, c / scale_block) f32 plane (an expert
    stack's: (E, r, c / scale_block))."""
    s = torch.exp2(scale_a[..., None, None] * scale_sint.to(torch.float32)
                   + scale_z[..., None, None])  # (..., n_cg, r, cg/Ns)
    return s.transpose(-3, -2).reshape(*s.shape[:-3], r, c // scale_block)


def _folded(vql: VQLinear) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(f32 codebooks with cb_scale folded in, scale plane or None)."""
    codebooks_f = (vql.codebooks.to(torch.float32)
                   * vql.cb_scale[..., None, None])
    scales = None
    if vql.scale_block:
        scales = _scale_plane(vql.scale_a, vql.scale_sint, vql.scale_z,
                              vql.r, vql.c, vql.scale_block)
    return codebooks_f, scales


def _stacked(leaf) -> bool:
    """True for an expert stack (a leading E on every array)."""
    return leaf.words.dim() > 2


def dequantize(vql: VQLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """Reconstruct W (r, c) — the gather form; an expert stack gives
    (E, r, c), expert by expert."""
    codebooks_f, scales = _folded(vql)
    kw = dict(d=vql.d, code_bits=vql.code_bits,
              rows_per_band=vql.rows_per_band, group_cols=vql.group_cols,
              scale_block=vql.scale_block)
    if not _stacked(vql):
        return vqdm.reconstruct(vql.words, codebooks_f, scales,
                                **kw).to(dtype)
    return torch.stack([
        vqdm.reconstruct(vql.words[e], codebooks_f[e],
                         None if scales is None else scales[e], **kw)
        for e in range(vql.words.shape[0])]).to(dtype)


def _map_leaves(tree, f):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, f) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, f) for v in tree]
    return f(tree)


def dequant_tree(tree, dtype=torch.bfloat16, densify_fused: bool = False):
    """Replace VQLinear leaves with dense (in, out) weights (an expert
    stack: (E, in, out)); other leaves pass through. FusedVQLinear leaves
    (consumed at the matmul sites) pass through too unless
    ``densify_fused``: the hybrid's shared attention block adds its LoRA
    deltas onto the dense q/k/v (``fused_dequantize``)."""
    def f(x):
        if isinstance(x, FusedVQLinear) and densify_fused:
            return fused_dequantize(x, dtype).T
        if not isinstance(x, VQLinear):
            return x
        COUNTS["gather"] += 1
        return dequantize(x, dtype).transpose(-1, -2)

    return _map_leaves(tree, f)


# ---------------------------------------------------------------------------
# fused path: one-time prep + per-matmul kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedVQLinear:
    """Prepped VQLinear: per-call scale and unpack work pre-folded."""

    words: torch.Tensor        # int32 packed codes as in VQLinear — the payload
    codebooks_f: torch.Tensor  # (n_cg, n_bands, k, d) f32, cb_scale folded
    scales: torch.Tensor | None  # (r, c/Ns) f32 plane, or None
    codebooks: torch.Tensor | None = None  # VQLinear's int8 codebooks
    cb_scale: torch.Tensor | None = None   # VQLinear's (n_cg, n_bands) f32
    r: int = 0
    c: int = 0
    d: int = 1
    k: int = 2
    group_cols: int = 256
    rows_per_band: int = 1
    scale_block: int = 0
    rule: str = ""
    # (lo, width): a model rank's columns [lo, lo + width) of the input
    # meet this whole leaf (``shard`` over column groups that do not split)
    in_window: tuple | None = None
    # the kernel's inputs checked once, as the leaf is made
    prepared: vqdm.Prepared = dataclasses.field(init=False, repr=False,
                                                compare=False)

    def __post_init__(self):
        self.prepared = vqdm.Prepared(
            self.words, self.codebooks_f, self.scales, d=self.d, k_c=self.k,
            code_bits=self.code_bits, rows_per_band=self.rows_per_band,
            group_cols=self.group_cols, scale_block=self.scale_block,
            codebooks_i8=self.codebooks, cb_scale=self.cb_scale)

    @property
    def code_bits(self) -> int:
        return _code_bits(self.k)

    def payload_bytes(self) -> int:
        """Bytes each matmul streams (words + folded codebooks + plane)."""
        return (self.words.numel() * 4 + self.codebooks_f.numel() * 4
                + (self.scales.numel() * 4 if self.scales is not None else 0))


def prepare_fused(vql: VQLinear) -> FusedVQLinear:
    """One-time VQLinear -> FusedVQLinear prep."""
    codebooks_f, scales = _folded(vql)
    return FusedVQLinear(
        words=vql.words.contiguous(), codebooks_f=codebooks_f.contiguous(),
        scales=None if scales is None else scales.contiguous(),
        codebooks=vql.codebooks.contiguous(),
        cb_scale=vql.cb_scale.to(torch.float32).contiguous(),
        r=vql.r, c=vql.c, d=vql.d, k=vql.k, group_cols=vql.group_cols,
        rows_per_band=vql.rows_per_band, scale_block=vql.scale_block,
        rule=vql.rule)


def prepare_fused_tree(tree):
    """VQLinear leaves -> FusedVQLinear (dense leaves untouched)."""
    return _map_leaves(
        tree, lambda x: prepare_fused(x) if isinstance(x, VQLinear) else x)


def fused_dequantize(fvl: FusedVQLinear,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Dense W (r, c) from a prepped leaf: the folded codebooks and scale
    plane decoded as ``dequantize`` decodes the raw leaf, so the two agree
    bit for bit. With an ``in_window`` (lo, width), its columns [lo, lo +
    width) only: the part a model rank's input meets."""
    W = vqdm.reconstruct(
        fvl.words, fvl.codebooks_f, fvl.scales, d=fvl.d,
        code_bits=fvl.code_bits, rows_per_band=fvl.rows_per_band,
        group_cols=fvl.group_cols, scale_block=fvl.scale_block).to(dtype)
    if fvl.in_window is not None:
        lo, width = fvl.in_window
        W = W[:, lo:lo + width]
    return W


def retag(tree, impl: str | None):
    """The tree in the execution form ``impl``: "fused" preps VQLinear
    leaves into FusedVQLinear (leaves already fused pass through), "gather"
    keeps VQLinear leaves for ``dequant_tree`` and refuses FusedVQLinear
    ones (their int8 codebooks are folded away), None leaves the tree as it
    is. The reference's "xla" and "pallas" are both "fused" here."""
    if impl is None:
        return tree
    if impl not in VQ_IMPLS:
        raise ValueError(f"vq matmul impl {impl!r} not in {VQ_IMPLS} (the "
                         "reference's 'xla' and 'pallas' are both 'fused' "
                         "here)")
    if impl == "fused":
        return prepare_fused_tree(tree)

    def check(x):
        if isinstance(x, FusedVQLinear):
            raise ValueError("the gather form needs VQLinear leaves; this "
                             "tree was prepped for the fused form")
        return x

    return _map_leaves(tree, check)


def fused_matmul(x: torch.Tensor, fvl: FusedVQLinear) -> torch.Tensor:
    """y = x @ W_io (f32) where W_io is the (in, out) dense view of ``fvl``;
    x may carry leading dims. The ``vq_dequant_matmul`` kernel on CUDA,
    its inputs other than x checked once, when the leaf was made
    (``fvl.prepared``). An expert stack goes through
    ``models/common.expert_matmul`` instead."""
    if _stacked(fvl):
        raise ValueError("a stacked FusedVQLinear goes through "
                         "models/common.expert_matmul")
    COUNTS["fused"] += 1
    if fvl.in_window is not None:  # the rank's columns of the whole input
        lo, width = fvl.in_window
        whole = x.new_zeros((*x.shape[:-1], fvl.c))
        whole[..., lo:lo + width] = x
        x = whole
    lead, K = x.shape[:-1], x.shape[-1]
    y = fvl.prepared(x.reshape(-1, K).contiguous())
    return y.reshape(*lead, fvl.r)


# each array's dim (from the end) a split cuts: over the out side (rows),
# over the in side (column groups); an expert stack's experts are dim 0
_ROW_DIMS = {"words": -2, "codebooks": -3, "cb_scale": -1, "scale_sint": -2,
             "codebooks_f": -3, "scales": -2}
_COL_DIMS = {"words": -1, "codebooks": -4, "cb_scale": -2, "scale_sint": -3,
             "scale_a": -1, "scale_z": -1, "codebooks_f": -4, "scales": -1}


def shard(leaf, dim: int, n: int, i: int):
    """Part ``i`` of ``n`` of a ``VQLinear`` or ``FusedVQLinear`` leaf,
    itself such a leaf: ``dim`` is the dense (..., in, out) weight's, so
    its out dim gives the leaf's rows (whole bands a part), its in dim
    its column groups (whole groups, and whole words of every row, a
    part), and a stack's leading dim its experts. Each array in storage
    of its own. A ``FusedVQLinear`` whose column groups do not split so
    stays whole, with the part's columns as its ``in_window``."""
    stacked = _stacked(leaf)
    side = dim - (3 if stacked else 2)  # -1 out, -2 in, -3 experts
    arrays = {f.name: getattr(leaf, f.name)
              for f in dataclasses.fields(leaf)
              if isinstance(getattr(leaf, f.name), torch.Tensor)}
    r, c = leaf.r, leaf.c
    if side == -3:
        dims = {k: 0 for k in arrays}
    elif side == -1:
        if (r // leaf.rows_per_band) % n or leaf.words.shape[-2] != r:
            raise ValueError(f"vq shard: {r} rows in bands of "
                             f"{leaf.rows_per_band} (words "
                             f"{tuple(leaf.words.shape)}) do not split "
                             f"{n} ways")
        dims, r = _ROW_DIMS, r // n
    else:
        lanes = 32 // packing.container_bits(leaf.code_bits)
        if ((c // leaf.group_cols) % n or leaf.words.shape[-2] != leaf.r
                or (c // n // leaf.d) % lanes):
            if isinstance(leaf, FusedVQLinear) and not stacked and c % n == 0:
                # the groups do not split: the rank keeps the whole leaf and
                # meets it with its columns of the input
                kw = {f.name: getattr(leaf, f.name)
                      for f in dataclasses.fields(leaf) if f.init}
                return FusedVQLinear(**{**kw, "in_window": (i * c // n,
                                                            c // n)})
            raise ValueError(f"vq shard: {c // leaf.group_cols} column "
                             f"groups (words {tuple(leaf.words.shape)}) do "
                             f"not split {n} ways on whole words")
        dims, c = _COL_DIMS, c // n
    parts = {k: t.chunk(n, dims[k] if dims[k] >= 0 else t.dim() + dims[k])[
        i].clone(memory_format=torch.contiguous_format)
        for k, t in arrays.items() if k in dims}
    parts.update({k: t for k, t in arrays.items() if k not in dims})
    kw = {f.name: getattr(leaf, f.name) for f in dataclasses.fields(leaf)
          if f.init}
    kw.update(parts, r=r, c=c)
    return type(leaf)(**kw)


def expert_fused_matmul(x: torch.Tensor, fvl: FusedVQLinear) -> torch.Tensor:
    """y (E, M, r) f32 = x (E, M, c) @ W_io[e] of a stacked ``fvl``: one
    ``vq_dequant_matmul`` launch for the whole stack on CUDA (the plain
    per-expert loop on the CPU)."""
    if not _stacked(fvl):
        raise ValueError("expert_fused_matmul takes a stacked FusedVQLinear")
    COUNTS["fused"] += 1
    return fvl.prepared(x.contiguous())


def quantize_array(W: torch.Tensor, H: torch.Tensor | None, cfg: VQConfig,
                   generator: torch.Generator | None = None) -> VQLinear:
    """Convenience: full GPTVQ pipeline on one matrix -> serving format."""
    from repro_torch.core import hessian as hes
    from repro_torch.core.codebook_compress import (
        codebook_update, quantize_codebooks)
    from repro_torch.core.gptvq import gptvq_quantize_matrix

    if H is None:
        H = torch.eye(W.shape[1], dtype=torch.float32, device=W.device)
    U = hes.inv_hessian_cholesky(H, cfg.percdamp)
    res = gptvq_quantize_matrix(W, U, cfg, generator)
    res = codebook_update(res, W, H)
    res = quantize_codebooks(res)
    return from_vq_result(res)
