"""The dry run's count of work: what each kernel launch does (its
operations and the bytes it must move) and what each collective carries.

``counting()`` turns the count on for a block and yields the ``Count``
it fills; off (the default) a site pays one check. The kernel wrappers
(``kernels/*``) record a launch here on fake tensors (the dry run: they
choose their variant as on the card, return outputs and scratch of the
kernel's shapes and dtypes, build and launch nothing, and leave their
launch counters alone) and, on real CUDA tensors, only while a count is
active, so a step on the card can be held to its trace. The collective
sites (``models/parallel.all_reduce`` / ``all_gather``,
``train/optimizer._sharded_squares``, ``core/hessian.accumulate_sharded``)
record the bytes of each collective's output by kind and by the mesh
axis of its group (the reference's convention, ``repro/launch/
roofline.py``: the output shape's bytes, within 2x of a ring's link
traffic).

The work formulas are the bound columns of PERF.md's kernel table (read
by ``chip_smoke.py`` too): each input read once and each output written
once, and the operations the function needs on these inputs, at the
rate of the units that can do them exactly (``RATE_BF16_TC``: bf16
products with an f32 sum on the tensor cores; ``RATE_FP32``: the FP32
CUDA cores; ``RATE_SPLIT6`` / ``RATE_SPLIT3``: f32 operands on the
tensor cores through the exact bf16 split, which issues six bf16
products for a product of two f32 operands and three for one with a
bf16 side, so the bf16 peak over six or three). ``FLOP_PER_S`` gives
each rate on the H100 (data sheet, dense).
"""
from __future__ import annotations

import contextlib
import dataclasses

from torch._subclasses.fake_tensor import FakeTensor

RATE_BF16_TC, RATE_FP32 = "bf16_tc", "fp32"
RATE_SPLIT6, RATE_SPLIT3 = "bf16_tc/6", "bf16_tc/3"
FLOP_PER_S = {RATE_BF16_TC: 989e12, RATE_SPLIT6: 989e12 / 6,
              RATE_SPLIT3: 989e12 / 3, RATE_FP32: 67e12}


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def aligned(t, n: int) -> bool:
    """Whether ``t``'s first element lies on ``n`` bytes: its address on
    the card; a fake tensor's offset in its storage (the card's caching
    allocator hands out storage on 512 bytes)."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size() % n == 0
    return t.data_ptr() % n == 0


@dataclasses.dataclass
class Count:
    """Kernel launches ({(name, variant): [launches, operations, bytes]})
    and collectives ({kind: {axis: [calls, output bytes]}}); ``axes`` maps
    a process group to its mesh axis name."""
    axes: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)

    def kernel_flops(self) -> float:
        return float(sum(v[1] for v in self.kernels.values()))

    def kernel_bytes(self) -> float:
        return float(sum(v[2] for v in self.kernels.values()))

    def launches(self) -> dict:
        """{name: {variant: launches}}."""
        out: dict = {}
        for (name, variant), v in sorted(self.kernels.items()):
            out.setdefault(name, {})[variant] = v[0]
        return out

    def collective_bytes(self) -> dict:
        """{kind: {axis: bytes}} and the total, as the record keeps them."""
        out = {k: {a: v[1] for a, v in sorted(ax.items())}
               for k, ax in sorted(self.collectives.items())}
        out["total"] = sum(b for ax in out.values() for b in ax.values())
        return out

    def as_dict(self) -> dict:
        return {"kernels": [
            {"name": n, "variant": var, "launches": v[0],
             "flops": float(v[1]), "bytes": float(v[2])}
            for (n, var), v in sorted(self.kernels.items())],
            "collectives": self.collective_bytes()}


_ACTIVE: list = [None]


def active() -> Count | None:
    return _ACTIVE[0]


@contextlib.contextmanager
def counting(axes: dict | None = None):
    """Count every kernel launch and collective inside the block;
    ``axes``: {process group: mesh axis name}."""
    prev, _ACTIVE[0] = _ACTIVE[0], Count(axes=dict(axes or {}))
    try:
        yield _ACTIVE[0]
    finally:
        _ACTIVE[0] = prev


def kernel(name: str, variant: str, work: tuple) -> None:
    """Record one launch of ``name``'s ``variant`` doing ``work``
    (operations, bytes, rate), when a count is active."""
    c = _ACTIVE[0]
    if c is None:
        return
    v = c.kernels.setdefault((name, variant), [0, 0.0, 0.0])
    v[0] += 1
    v[1] += work[0]
    v[2] += work[1]


def collective(kind: str, group, nbytes: int) -> None:
    """Record one collective of ``kind`` over ``group`` whose output holds
    ``nbytes``, when a count is active."""
    c = _ACTIVE[0]
    if c is None:
        return
    axis = c.axes.get(group, "other")
    v = c.collectives.setdefault(kind, {}).setdefault(axis, [0, 0])
    v[0] += 1
    v[1] += int(nbytes)


def nbytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# each kernel's work: (operations, bytes, rate)
# ---------------------------------------------------------------------------

def vq_assign_work(B: int, n: int, k: int, d: int, hw_numel: int) -> tuple:
    """Each point's weighted distance to the k centroids (4 a coordinate);
    x, the weights and the codebooks read, the indices written."""
    return (4.0 * B * n * k * d,
            4.0 * (B * n * d + hw_numel + B * k * d + B * n), RATE_FP32)


def vq_group_sweep_work(r: int, cg: int, d: int, k: int, c_numel: int,
                        metric_numel: int = 0) -> tuple:
    """W read and written, S read, U's upper triangle, the codebooks, the
    weights (and metrics) read, Q, E and the indices written; each span's
    distances to the k centroids (diagonal: 4 a coordinate; babai: y's 2
    and y M y's 2 + 2d a coordinate) and the in-group update's
    multiply-adds."""
    spans = cg // d
    per_coord = 4.0 + 2.0 * d if metric_numel else 4.0
    # sum over spans j of (cg - (j + 1) d), in closed form
    tail = spans * cg - d * spans * (spans + 1) // 2
    flops = per_coord * k * r * cg + 2.0 * r * d * tail
    nbytes_ = 4.0 * (5 * r * cg + cg * (cg + 1) // 2 + c_numel + cg
                     + r * spans + metric_numel)
    return flops, nbytes_, RATE_FP32


def vq_em_work(B: int, n: int, d: int, k: int, hw_numel: int,
               iters: int) -> tuple:
    """X, the weights and the seeds read once, the codebooks written; each
    step's distances (4 a coordinate a centroid) and its M-step sums (a
    multiply-add and an add a coordinate)."""
    return (iters * B * n * d * (4.0 * k + 3.0),
            4.0 * (B * n * d + hw_numel + 2 * B * k * d), RATE_FP32)


def vq_dequant_matmul_work(E: int, M: int, N: int, K: int, x_itemsize: int,
                           words_numel: int, cb_bytes: int,
                           scales_numel: int, exact_terms: int) -> tuple:
    """x, the words, the codebooks read (int8 and their scales, or f32),
    the plane, y written; 2MNK an expert on the bf16 tensor cores, where
    bf16 x times a bf16-exact W is exact with an f32 sum: int8 codebook
    values as they are (``exact_terms`` 1), an arbitrary f32 value as
    three bf16 terms (3)."""
    return (2.0 * E * M * N * K * exact_terms,
            float(E * M * K * x_itemsize + words_numel * 4 + cb_bytes
                  + scales_numel * 4 + E * M * N * 4), RATE_BF16_TC)


def paged_attention_work(rows: int, B: int, H: int, KV: int, hd: int,
                         row_bytes: int, q_itemsize: int, table_numel: int,
                         vq2: bool) -> tuple:
    """``rows`` (every slot's attended rows, summed): their K and V rows
    and scales read, q read and out written, the table and positions, the
    vq2 codebooks; q.k and p.v, 4 hd a row and head, on the FP32 cores."""
    return (4.0 * rows * H * hd,
            float(2 * rows * KV * row_bytes + 2 * B * H * hd * q_itemsize
                  + table_numel * 4 + B * 4 + (2 * KV * 32 * 4 if vq2 else 0)),
            RATE_FP32)


def flash_pairs(Sq: int, Sk: int, q_offset: int, causal: bool) -> int:
    """Unmasked (row, column) pairs of one (batch, head): row i sees
    columns j <= q_offset + i under ``causal``."""
    if not causal:
        return Sq * Sk
    # sum over i < Sq of min(Sk, q_offset + i + 1), in closed form
    n1 = max(0, min(Sq, Sk - q_offset))
    return n1 * (q_offset + 1) + n1 * (n1 - 1) // 2 + (Sq - n1) * Sk


def flash_rate(q_bf16: bool, kv_bf16: bool) -> str:
    """The rate of the flash pair's products on these dtypes: bf16 q and
    k/v at the tensor-core peak; an f32 side through the exact split, six
    bf16 products a product when both sides are f32, three when one is
    bf16 (the scores' and P's f32 stay inside the kernel, as for bf16)."""
    if q_bf16 and kv_bf16:
        return RATE_BF16_TC
    return RATE_SPLIT3 if q_bf16 or kv_bf16 else RATE_SPLIT6


def flash_attention_work(B: int, Sq: int, Sk: int, H: int, KV: int,
                         hd: int, q_offset: int, causal: bool,
                         itemsize: int, rate: str,
                         lse: bool = False) -> tuple:
    """Every unmasked pair costs 2 hd of q.k and 2 hd of p.v a head; q, k,
    v read and out (and the lse) written; at ``rate`` (``flash_rate``)."""
    pairs = flash_pairs(Sq, Sk, q_offset, causal)
    nbytes_ = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * itemsize
    if lse:
        nbytes_ += B * H * Sq * 4
    return 4.0 * hd * pairs * B * H, float(nbytes_), rate


def flash_attention_bwd_work(B: int, Sq: int, Sk: int, H: int, KV: int,
                             hd: int, q_offset: int, causal: bool,
                             q_itemsize: int, kv_itemsize: int,
                             rate: str) -> tuple:
    """The five products the backward needs (S, dP, dV, dK, dQ: 2.5 times
    the forward's two); q, k, v, out, dout, lse read once and dq, dk, dv
    written once; at ``rate`` (``flash_rate``)."""
    pairs = flash_pairs(Sq, Sk, q_offset, causal)
    q_b = B * Sq * H * hd * q_itemsize
    kv_b = B * Sk * KV * hd * kv_itemsize
    nbytes_ = 4 * q_b + 4 * kv_b + B * H * Sq * 4
    return 2.5 * 4.0 * hd * pairs * B * H, float(nbytes_), rate
