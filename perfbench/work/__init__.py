"""The yardstick's arithmetic of work: the operations a kernel's call needs
and the bytes it must move, counted from its logical shapes, and the
H100's peaks they are held to.

A frozen copy of the port's ``obs/work.py`` formulas (the bound columns of
PERF.md's kernel table) and of NVIDIA's data-sheet peaks, so that a later
change to the program cannot move the bar it is measured against. Each
input is read once and each output written once, whatever a kernel reads
again. ``tests/test_perfbench_work.py`` holds these equal to the port's at
the cells' shapes. The operation counts of a whole GPTVQ matrix and of a
decoder block's calibration passes, at the end, are the yardstick's own
(the port has none): what ``step_mfu.quant`` divides by the peak.
"""
from __future__ import annotations

RATE_BF16_TC, RATE_FP32 = "bf16_tc", "fp32"
# one NVIDIA H100 SXM, dense, at its 700 W limit (data sheet)
FLOP_PER_S = {RATE_BF16_TC: 989e12, RATE_FP32: 67e12}
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(work: tuple) -> float:
    """The least time the chip could take for (operations, bytes, rate):
    the larger of the operations at their rate and the bytes at HBM's."""
    flops, nbytes, rate = work
    return max(flops / FLOP_PER_S[rate], nbytes / HBM_BYTES_PER_S)


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


def vq_group_sweep_work(r: int, cg: int, d: int, k: int, c_numel: int,
                        metric_numel: int = 0) -> tuple:
    """W read and written, S read, U's upper triangle, the codebooks, the
    weights (and metrics) read, Q, E and the indices written; each span's
    distances to the k centroids and the in-group update's multiply-adds."""
    spans = cg // d
    per_coord = 4.0 + 2.0 * d if metric_numel else 4.0
    tail = spans * cg - d * spans * (spans + 1) // 2
    flops = per_coord * k * r * cg + 2.0 * r * d * tail
    nbytes = 4.0 * (5 * r * cg + cg * (cg + 1) // 2 + c_numel + cg
                    + r * spans + metric_numel)
    return flops, nbytes, RATE_FP32


def vq_em_work(B: int, n: int, d: int, k: int, hw_numel: int,
               iters: int) -> tuple:
    """X, the weights and the seeds read once, the codebooks written; each
    step's distances (4 a coordinate a centroid) and its M-step sums."""
    return (iters * B * n * d * (4.0 * k + 3.0),
            4.0 * (B * n * d + hw_numel + 2 * B * k * d), RATE_FP32)


def logits_flops(d_model: int, vocab: int, rows: int) -> float:
    """The output head's operations for ``rows`` sampled positions."""
    return 2.0 * d_model * vocab * rows


# -- GPTVQ on one matrix, and a decoder block's calibration passes -----------

def gptvq_groups(r: int, c: int, quant: dict) -> list:
    """Per column group: (vq_group_sweep work, vq_em work, tail update
    operations) of one (r, c) matrix at the setting (``quant``: d,
    bits_per_dim, group_size, group_cols, em_iters), with the group plan
    of ``reference/vq.plan_groups``."""
    from perfbench.reference import vq

    d = quant["d"]
    k = int(round(2 ** (d * quant["bits_per_dim"])))
    cg, rg = vq.plan_groups(r, c, d, quant["group_size"], quant["group_cols"])
    B, n = r // rg, rg * cg // d
    out = []
    for g in range(c // cg):
        tail = 2.0 * r * cg * (c - (g + 1) * cg)
        out.append((vq_group_sweep_work(r, cg, d, k, B * k * d, 0),
                    vq_em_work(B, n, d, k, n * d, quant["em_iters"]), tail))
    return out


def gptvq_matrix_flops(r: int, c: int, quant: dict) -> float:
    """Operations GPTVQ needs for one (r, c) matrix: the inverse Hessian's
    Cholesky factors (c^3), each group's EM and sweep and the error fed
    to the columns past it, and the codebook update's steps (a forward
    and a backward of tr(E H E^T): 4 r c^2 each), with the objective's
    normaliser and the reconstruction error (2 r c^2 each)."""
    groups = sum(s[0] + e[0] + t for s, e, t in gptvq_groups(r, c, quant))
    return (float(c) ** 3 + groups
            + (4.0 * quant["codebook_update_iters"] + 4.0) * r * c * c)


def moe_block_flops(n: dict, tokens: int, seq: int, capture: bool) -> float:
    """A Qwen3-MoE block over ``tokens`` calibration tokens in sequences of
    ``seq`` (``n``: D, H, KV, hd, F, E, K): q, k, v and o, causal q.k and
    p.v, the router, and each token's K experts; the capture stops at
    the experts' hidden states (w_in, w_gate) and adds every tap's
    x x^T (attention in, o, each routed token's expert in and hidden);
    the advance runs the whole block (w_out too)."""
    D, H, KV, hd, F, E, K = (n["D"], n["H"], n["KV"], n["hd"], n["F"],
                             n["E"], n["K"])
    per = (2.0 * D * (H + 2 * KV) * hd + 2.0 * H * hd * D
           + 4.0 * hd * H * (seq + 1) / 2 + 2.0 * D * E)
    if capture:
        per += K * 4.0 * D * F + 2.0 * (D * D + (H * hd) ** 2) \
            + K * 2.0 * (D * D + F * F)
    else:
        per += K * 6.0 * D * F
    return per * tokens
