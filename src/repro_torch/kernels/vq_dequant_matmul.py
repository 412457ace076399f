"""Fused VQ-decode + matmul: y = x @ dequant(words, codebooks).T in f32.

Port of ``repro/kernels/vq_dequant_matmul.py``. ``vq_dequant_matmul``
launches the CUDA kernel ``csrc/vq_dequant_matmul.cu`` for CUDA tensors and
takes the plain PyTorch version ``vq_dequant_matmul_plain`` only for CPU
tensors. The kernel has four variants, picked by ``select_impl`` from M, x's
dtype and the layout (never by a failure):

  * ``splitk``    M <= 16, any x dtype (the engine's decode ticks): split-K
                  streaming on the CUDA cores, the plan from ``splitk_plan``
                  (it depends on N, K and the layout only, so each row of y
                  is the same bit for bit whatever else the batch holds);
  * ``tc_int8``   M > 16, bf16 x, int8 codebooks given (``codebooks_i8`` and
                  ``cb_scale``), column groups and plane blocks multiples of
                  64: bf16 tensor cores on the int8 values, each column
                  group's partial sum scaled in f32 as the group ends;
  * ``tc_split3`` M > 16, bf16 x otherwise (e.g. arbitrary f32 codebooks):
                  the same tiles with each f32 W value split exactly into
                  three bf16 terms;
  * ``fp32``      M > 16, f32 x (or d outside {1, 2, 4}): FP32 CUDA cores.

An expert stack (a mixture-of-experts layer's E matrices of one layout:
every array below with a leading E, x (E, M, K), y (E, M, N)) runs in one
launch: the kernel's grid has a third axis over experts, and each expert's
rows of y are bitwise what a 2-D launch on its slice gives (the variant and
split plan are chosen from one expert's M, N, K and layout, as for a 2-D
call). ``Prepared`` checks a stack's layout once; a stack the grouped
launch cannot take raises ``ValueError`` (it is never split into 2-D
launches). Its plain version is the per-expert loop of
``vq_dequant_matmul_plain``.

``vq_dequant_matmul.launches`` counts kernel launches (a stack's one),
``launches_by_m`` the same launches by M (one expert's rows),
``launches_by_impl`` by variant and ``launches_by_experts`` a stack's
launches by its expert count; CPU tensors touch none of them.
Fake tensors (the dry run, ``launch/dryrun``) launch nothing: the
variant is chosen as on the card, the kernel's outputs and scratch are
made, the work is recorded in ``obs/work`` and the launch counters stay
as they were; on CUDA tensors the same record is made while a count is
on.

Layout (core/vq_linear.FusedVQLinear): x (M, K) f32 or bf16; words: the
N * K/d codes packed row-major into int32 words holding uint32 bit
patterns, (N, K/d * cbits/32) when rows fill whole words, else one flat
run (1, N * K/d * cbits/32); codebooks (n_cg, n_bands, k_c, d) f32 with the
int8 scale folded in; optionally codebooks_i8 (same shape, int8) and
cb_scale (n_cg, n_bands) f32, whose product is ``codebooks``; scales
(N, K/scale_block) f32 or None; N = n_bands * rows_per_band,
K = n_cg * group_cols.
"""
from __future__ import annotations

import array
import dataclasses
import functools

import torch

from repro_torch.core import packing
from repro_torch.core.gptvq import gather_codebooks
from repro_torch.kernels import build
from repro_torch.obs import work

IMPLS = ("splitk", "tc_int8", "tc_split3", "fp32")
_IMPL_CODE = {"fp32": 0, "splitk": 1, "tc_int8": 2, "tc_split3": 3}
SPLITK_M_MAX = 16
_TILE_N = 64  # W rows of a CTA in every variant
# codebook slice of one column group for a 64-row tile, in shared memory as
# f32: the most any variant stages
_CB_SMEM_LIMIT = 200 * 1024
# split-K: a split spans whole column groups, up to 1024 columns (16
# chunks of 64 a row, one for each lane of a row quad); a CTA stages at
# most 1024 columns of x (256 when the codebook slice is large) and about
# 48 KB of codebooks at a time
_SPLITK_SEG_COLS, _SPLITK_SEG_COLS_BIG_CB = 1024, 256
_SPLITK_CB_BUDGET, _SPLITK_BIG_CB = 48 * 1024, 100 * 1024
# (d, container bits) with an unrolled 16-byte-load path: the paper's
# presets (1D at 2/3/4 bits, 2D at 4/6/8 bits, 4D at 8 bits)
_SPLITK_FAST = {(1, 2), (1, 4), (2, 4), (2, 8), (4, 8)}
# tensor cores: 64-column k-steps; the int8 form keeps three int8 slices
# in flight (4-byte copies)
TC_BK = 64
_TC_CB_LIMIT = 96 * 1024


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How ``splitk`` cuts K: ``groups_per_split`` whole column groups a
    split (the last may hold fewer), ``n_splits`` splits, ``seg_cols``
    columns of x a CTA stages at a time, ``vec`` words a load (4: 16-byte
    loads, when every row's chunk of a segment starts on one)."""

    groups_per_split: int
    n_splits: int
    seg_cols: int
    vec: int


def _cb_slice_bytes(k_c: int, d: int, rows_per_band: int,
                    n_bands: int) -> int:
    """Bytes of one column group's f32 codebooks for the most bands a
    64-row tile can touch."""
    nb = min(n_bands, (_TILE_N + rows_per_band - 2) // rows_per_band + 1)
    return nb * k_c * d * 4


@functools.lru_cache(maxsize=4096)
def splitk_plan(N: int, K: int, *, d: int, code_bits: int, k_c: int,
                rows_per_band: int, group_cols: int,
                words_aligned: bool = True) -> SplitPlan:
    """The split-K plan: a function of N, K and the layout only (never of
    M), so the order of every sum is too. ``words_aligned``: the words
    tensor starts on 16 bytes."""
    n_cg = K // group_cols
    slice_b = _cb_slice_bytes(k_c, d, rows_per_band, N // rows_per_band)
    seg_max = (_SPLITK_SEG_COLS if slice_b <= _SPLITK_BIG_CB
               else _SPLITK_SEG_COLS_BIG_CB)
    if group_cols <= seg_max:
        gps = max(1, min(n_cg, seg_max // group_cols))
        seg_cols = max(1, min(gps, _SPLITK_CB_BUDGET // slice_b)) * group_cols
    else:  # a split is one group, staged seg_max columns at a time
        gps, seg_cols = 1, seg_max
    cbits = packing.container_bits(code_bits)
    lanes = 32 // cbits
    nspans, cw = K // d, 4 * lanes
    vec = 4 if (words_aligned and (d, cbits) in _SPLITK_FAST
                and nspans % lanes == 0
                and (nspans // lanes) % 4 == 0
                and (group_cols // d) % cw == 0
                and (seg_cols // d) % cw == 0) else 1
    return SplitPlan(gps, -(-n_cg // gps), seg_cols, vec)


_NO_PLAN = SplitPlan(1, 1, 0, 1)  # the tensor-core and FP32 variants


def select_impl(M: int, x_dtype, *, d: int, k_c: int, rows_per_band: int,
                n_bands: int, group_cols: int, scale_block: int,
                has_int8: bool) -> str:
    """The kernel variant for these inputs (see the module docstring)."""
    if M <= SPLITK_M_MAX:
        return "splitk"
    if x_dtype == torch.bfloat16 and d in (1, 2, 4):
        if (has_int8 and group_cols % TC_BK == 0
                and scale_block % TC_BK == 0 and (k_c * d) % 4 == 0
                and 3 * _cb_slice_bytes(k_c, d, rows_per_band, n_bands) // 4
                <= _TC_CB_LIMIT):
            return "tc_int8"
        return "tc_split3"
    return "fp32"


def reconstruct(words, codebooks, scales, *, d: int, code_bits: int,
                rows_per_band: int, group_cols: int,
                scale_block: int = 0) -> torch.Tensor:
    """Dense f32 W (N, K): unpack -> per-(group, band) codebook gather ->
    blockwise scale plane."""
    n_cg, n_bands = codebooks.shape[:2]
    N, K = n_bands * rows_per_band, n_cg * group_cols
    codes = packing.unpack(words, code_bits, N * (K // d)).reshape(N, K // d)
    W = gather_codebooks(codebooks, codes, group_cols, rows_per_band, d)
    if scale_block:
        W = (W.reshape(N, K // scale_block, scale_block)
             * scales[:, :, None]).reshape(N, K)
    return W


def vq_dequant_matmul_plain(x, words, codebooks, scales=None, *, d: int,
                            code_bits: int, rows_per_band: int,
                            group_cols: int,
                            scale_block: int = 0) -> torch.Tensor:
    """Plain version, the same math as ``ref.vq_dequant_matmul_ref``."""
    W = reconstruct(words, codebooks, scales, d=d, code_bits=code_bits,
                    rows_per_band=rows_per_band, group_cols=group_cols,
                    scale_block=scale_block)
    return x.to(torch.float32) @ W.T


def vq_dequant_matmul_experts_plain(x, words, codebooks, scales=None, *,
                                    d: int, code_bits: int,
                                    rows_per_band: int, group_cols: int,
                                    scale_block: int = 0) -> torch.Tensor:
    """Plain version of a stack: x (E, M, K), every other array with a
    leading E; returns (E, M, N) f32, expert by expert."""
    return torch.stack([vq_dequant_matmul_plain(
        x[e], words[e], codebooks[e],
        None if scales is None else scales[e], d=d, code_bits=code_bits,
        rows_per_band=rows_per_band, group_cols=group_cols,
        scale_block=scale_block) for e in range(x.shape[0])])


def _layout_error(K, words_shape, cb_shape, scales_shape, i8_shapes, d, k_c,
                  code_bits, rows_per_band, group_cols,
                  scale_block) -> str | None:
    """What is inconsistent in these shapes and this layout, or None."""
    if len(cb_shape) != 4 or len(words_shape) != 2:
        return (f"inconsistent layout K={K} words {tuple(words_shape)} "
                f"codebooks {tuple(cb_shape)}")
    n_cg, n_bands, kc, dd = cb_shape
    N = n_bands * rows_per_band
    lanes = 32 // packing.container_bits(code_bits)
    if (dd != d or kc != k_c or 32 % d or n_cg * group_cols != K
            or group_cols % d or code_bits > 16
            or words_shape[0] * words_shape[1] * lanes != N * (K // d)):
        return (f"inconsistent layout K={K} words {tuple(words_shape)} "
                f"codebooks {tuple(cb_shape)} d={d} k_c={k_c} "
                f"group_cols={group_cols} rows_per_band={rows_per_band}")
    slice_b = _cb_slice_bytes(k_c, d, rows_per_band, n_bands)
    if slice_b > _CB_SMEM_LIMIT:
        return (f"codebook slice of {slice_b // (k_c * d * 4)} bands x "
                f"{k_c} x {d} exceeds shared memory")
    if scale_block and (K % scale_block
                        or tuple(scales_shape) != (N, K // scale_block)):
        return f"scales {tuple(scales_shape)} vs (N, K/{scale_block})"
    if i8_shapes is not None and (tuple(i8_shapes[0]) != tuple(cb_shape)
                                  or tuple(i8_shapes[1]) != (n_cg, n_bands)):
        return (f"codebooks_i8 {tuple(i8_shapes[0])} / cb_scale "
                f"{tuple(i8_shapes[1])} vs codebooks {tuple(cb_shape)}")
    return None


_MAX_EXPERTS = 65535  # the grid's third axis


class Prepared:
    """The static inputs of ``vq_dequant_matmul`` (everything but x),
    checked once; calling it with x runs the matmul. A fused leaf keeps one
    (core/vq_linear.FusedVQLinear), so that a decode tick's calls check
    only x. Given codebooks (E, n_cg, n_bands, k_c, d) and every other
    array with the same leading E, it is an expert stack: x (E, M, K) in,
    (E, M, N) out, one launch."""

    def __init__(self, words, codebooks, scales=None, *, d: int, k_c: int,
                 code_bits: int, rows_per_band: int, group_cols: int,
                 scale_block: int = 0, codebooks_i8=None, cb_scale=None):
        if (scales is not None) != bool(scale_block):
            raise ValueError("scales must be given iff scale_block != 0")
        if (codebooks_i8 is None) != (cb_scale is None):
            raise ValueError("codebooks_i8 and cb_scale go together")
        dev = words.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"vq_dequant_matmul: unsupported device {dev}")
        stacked = codebooks.dim() == 5
        E = codebooks.shape[0] if stacked else 0
        arrays = (("words", words), ("codebooks", codebooks),
                  ("scales", scales), ("codebooks_i8", codebooks_i8),
                  ("cb_scale", cb_scale))
        if stacked:
            lead = {name: (t.dim(), t.shape[0]) for name, t in arrays
                    if t is not None}
            want = {"words": 3, "codebooks": 5, "scales": 3,
                    "codebooks_i8": 5, "cb_scale": 3}
            bad = [n for n, (nd, e) in lead.items()
                   if nd != want[n] or e != E]
            if bad or not 1 <= E <= _MAX_EXPERTS:
                raise ValueError(
                    f"vq_dequant_matmul: an expert stack needs 1..."
                    f"{_MAX_EXPERTS} experts and the same leading E on "
                    f"every array; got {E} experts, (ndim, E) {lead}")
        one = (lambda t: t[0]) if stacked else (lambda t: t)
        cb1 = one(codebooks)
        K = cb1.shape[0] * group_cols if cb1.dim() == 4 else -1
        err = _layout_error(
            K, tuple(one(words).shape), tuple(cb1.shape),
            tuple(one(scales).shape) if scale_block else None,
            None if codebooks_i8 is None else (tuple(one(codebooks_i8).shape),
                                               tuple(one(cb_scale).shape)),
            d, k_c, code_bits, rows_per_band, group_cols, scale_block)
        if err is not None:
            raise ValueError(f"vq_dequant_matmul: {err}")
        for name, t, dt in (("words", words, torch.int32),
                            ("codebooks", codebooks, torch.float32),
                            ("scales", scales, torch.float32),
                            ("codebooks_i8", codebooks_i8, torch.int8),
                            ("cb_scale", cb_scale, torch.float32)):
            if t is not None and (t.dtype != dt or t.device != dev
                                  or not t.is_contiguous()):
                raise ValueError(f"vq_dequant_matmul: {name} must be a "
                                 f"contiguous {dt} tensor on {dev}")
        self.words, self.codebooks, self.scales = words, codebooks, scales
        self.codebooks_i8, self.cb_scale = codebooks_i8, cb_scale
        self.device, self.K, self.n_experts = dev, K, E
        self.n_bands = cb1.shape[1]
        self.N = self.n_bands * rows_per_band
        self.layout = (d, k_c, code_bits, rows_per_band, group_cols,
                       scale_block)
        self.fake = work.is_fake(words)  # the dry run: nothing launches
        if dev.type == "cuda":
            if not self.fake:
                self.ptrs = (words.data_ptr(), codebooks.data_ptr(),
                             0 if codebooks_i8 is None
                             else codebooks_i8.data_ptr(),
                             0 if cb_scale is None else cb_scale.data_ptr(),
                             scales.data_ptr() if scale_block else 0)
            # an expert's words, codebooks, ... start where the previous
            # expert's end (elements a stride; 0 for one matrix)
            self.strides = tuple(
                0 if t is None or not stacked else t[0].numel()
                for t in (words, codebooks, cb_scale, scales))
            es_words, es_cb = self.strides[:2]
            # every expert's slice keeps the alignment of the first
            self.int8_ok = (codebooks_i8 is not None
                            and work.aligned(codebooks_i8, 4)
                            and es_cb % 4 == 0)
            self.words_aligned = (work.aligned(words, 16)
                                  and (es_words * 4) % 16 == 0)

    def work(self, M: int, x) -> tuple:
        """``obs.work``'s (operations, bytes, rate) of a call on x (M rows
        an expert): the int8 codebooks and their scales where given, else
        the f32 ones, whose values take three exact bf16 terms."""
        i8 = self.codebooks_i8 is not None
        cb_bytes = (self.codebooks_i8.numel() + self.cb_scale.numel() * 4
                    if i8 else self.codebooks.numel() * 4)
        return work.vq_dequant_matmul_work(
            max(self.n_experts, 1), M, self.N, self.K, x.element_size(),
            self.words.numel(), cb_bytes,
            0 if self.scales is None else self.scales.numel(),
            1 if i8 else 3)

    def __call__(self, x) -> torch.Tensor:
        """y = x @ W.T, (M, N) f32, for x (M, K) f32 or bf16 on the same
        device (a stack: x (E, M, K), y (E, M, N)): the CUDA kernel, or on
        the CPU its plain version."""
        d, k_c, code_bits, rpb, gc, sb = self.layout
        K, N, dev, E = self.K, self.N, self.device, self.n_experts
        want = (E, K) if E else (K,)
        if (x.dim() != len(want) + 1 or tuple(x.shape[:-2]) != want[:-1]
                or x.shape[-1] != K
                or x.dtype not in (torch.float32, torch.bfloat16)
                or x.device != dev or not x.is_contiguous()):
            rows = f"({E}, M, {K})" if E else f"(M, {K})"
            raise ValueError(
                f"vq_dequant_matmul: x must be a contiguous {rows} f32 or "
                f"bf16 tensor on {dev}, not {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")
        if not x.is_cuda:
            plain = (vq_dequant_matmul_experts_plain if E
                     else vq_dequant_matmul_plain)
            return plain(x, self.words, self.codebooks, self.scales, d=d,
                         code_bits=code_bits, rows_per_band=rpb,
                         group_cols=gc, scale_block=sb)
        M, n_e = x.shape[-2], max(E, 1)
        if M == 0 or N == 0:
            return torch.empty((*want[:-1], M, N), dtype=torch.float32,
                               device=dev)
        is_bf16 = x.dtype == torch.bfloat16
        impl, code, plan, cbits = _launch_config(
            M, is_bf16, N, K, d, k_c, code_bits, rpb, gc, sb, self.int8_ok,
            self.words_aligned)
        ldx = K
        if code >= 2 and (K % 8 or not work.aligned(x, 16)):
            # tensor cores copy x's rows 16 bytes at a time: pad the stride
            ldx = -(-K // 8) * 8
            xp = torch.zeros((*want[:-1], M, ldx), dtype=x.dtype, device=dev)
            xp[..., :K] = x
            x = xp
        # y and, with more than one split, the (splits, E, M, N) partial
        # sums
        mn = n_e * M * N
        n_part = plan.n_splits if plan.n_splits > 1 else 0
        buf = torch.empty(((1 + n_part) * mn,), dtype=torch.float32,
                          device=dev)
        if self.fake or work.active() is not None:
            work.kernel("vq_dequant_matmul", impl, self.work(M, x))
        if self.fake:  # the dry run: the kernel's outputs, nothing run
            return buf[:mn].view(*want[:-1], M, N)
        words_p, cb_p, i8_p, scale_p, plane_p = self.ptrs
        es_words, es_cb, es_cb_scale, es_scales = self.strides
        use_i8 = code != 0 and i8_p != 0
        ptr = buf.data_ptr()
        # every argument in one int64 array, in the C side's order
        args = array.array("q", (
            x.data_ptr(), is_bf16, ldx, words_p, cb_p,
            i8_p if use_i8 else 0, scale_p if use_i8 else 0, plane_p, ptr,
            ptr + 4 * mn if n_part else 0, M, N, K, d, k_c, cbits, rpb,
            gc, sb, self.n_bands, code, plan.groups_per_split,
            plan.n_splits, plan.seg_cols, plan.vec, n_e,
            M * ldx * x.element_size() if E else 0, es_words, es_cb,
            es_cb_scale, es_scales, build.current_stream(dev)))
        rc = build.load("vq_dequant_matmul").vq_dequant_matmul_launch(
            args.buffer_info()[0])
        if rc:
            build.check(rc, f"vq_dequant_matmul ({impl})")
        vq_dequant_matmul.launches += 1
        counts = [(vq_dequant_matmul.launches_by_m, M),
                  (vq_dequant_matmul.launches_by_impl, impl)]
        if E:
            counts.append((vq_dequant_matmul.launches_by_experts, E))
        for c, key in counts:
            c[key] = c.get(key, 0) + 1
        return buf[:mn].view(*want[:-1], M, N)


def vq_dequant_matmul(x, words, codebooks, scales=None, *, d: int, k_c: int,
                      code_bits: int, rows_per_band: int, group_cols: int,
                      scale_block: int = 0, codebooks_i8=None,
                      cb_scale=None) -> torch.Tensor:
    """y = x @ dequant(words, codebooks[, scales]).T ; returns (M, N) f32.
    ``codebooks_i8`` and ``cb_scale`` (both or neither) are the int8
    codebooks and scales whose product is ``codebooks``; the kernel reads
    them where it can (fewer bytes, exact on bf16 tensor cores), the plain
    version reads ``codebooks``. Inputs are checked on every device, so
    CPU callers meet the kernel's contract too."""
    return Prepared(words, codebooks, scales, d=d, k_c=k_c,
                    code_bits=code_bits, rows_per_band=rows_per_band,
                    group_cols=group_cols, scale_block=scale_block,
                    codebooks_i8=codebooks_i8, cb_scale=cb_scale)(x)


@functools.lru_cache(maxsize=4096)
def _launch_config(M, is_bf16, N, K, d, k_c, code_bits, rows_per_band,
                   group_cols, scale_block, has_int8, words_aligned):
    """(variant, its code for the C side, split plan, container bits) of a
    call: pure in its arguments, so cached."""
    impl = select_impl(M, torch.bfloat16 if is_bf16 else torch.float32,
                       d=d, k_c=k_c, rows_per_band=rows_per_band,
                       n_bands=N // rows_per_band, group_cols=group_cols,
                       scale_block=scale_block, has_int8=has_int8)
    plan = _NO_PLAN
    if impl == "splitk":
        plan = splitk_plan(N, K, d=d, code_bits=code_bits, k_c=k_c,
                           rows_per_band=rows_per_band,
                           group_cols=group_cols,
                           words_aligned=words_aligned)
    return impl, _IMPL_CODE[impl], plan, packing.container_bits(code_bits)


vq_dequant_matmul.launches = 0
vq_dequant_matmul.launches_by_m = {}  # M (rows of x) -> launches
vq_dequant_matmul.launches_by_impl = {}  # variant (IMPLS) -> launches
vq_dequant_matmul.launches_by_experts = {}  # a stack's E -> launches
