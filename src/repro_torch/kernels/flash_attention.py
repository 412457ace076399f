"""Online-softmax (flash) attention for long sequences.

Port of ``repro/kernels/flash_attention.py`` (the Pallas kernel) and of its
oracle, the two-level scan of ``repro/models/attention.py::flash_attention``.
For CUDA tensors ``flash_attention`` launches the CUDA kernel
``csrc/flash_attention.cu``; for CPU tensors it runs the plain PyTorch
version ``flash_attention_plain``. The kernel has two variants, picked by
``select_impl`` from the dtypes and the head dim (never by a failure):
``tc`` (q, k and v bf16, head_dim a multiple of 16 up to 128, 16-byte
aligned: both products on bf16 tensor cores, p split exactly into three
bf16 terms) and ``fp32`` (everything else: f32 or mixed dtypes, other head
dims, any alignment; both products on the same tensor cores with every f32
operand split exactly into three bf16 terms, so each product issues the
bf16 products that keep f32's accuracy: six for f32 x f32, three with a
bf16 side). ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_impl`` the same by variant; CPU tensors
touch neither. Fake tensors (the dry run, ``launch/dryrun``) launch nothing: the
variant is chosen as on the card, the kernel's outputs and scratch are
made, the work is recorded in ``obs/work`` and the launch counters stay
as they were; on CUDA tensors the same record is made while a count is
on.

q (B, Sq, H, hd) and k/v (B, Sk, KV, hd), f32 or bf16, give (B, Sq, H, hd)
in q's dtype: query head h reads kv head h // (H // KV), and under
``causal`` row i sees the columns j <= q_offset + i (q_offset >= 0 places
q's rows at absolute positions in the kv range). Scores, probabilities and
the accumulator are f32; unlike the short-sequence path
(``models/attention._plain_attention``) the probabilities are not rounded
to v's dtype before the value contraction.

Gradients: when autograd records (grad mode on and an input requiring
grad) ``flash_attention`` goes through ``FlashAttentionFn``, whose forward
launches the kernel with its log-sum-exp output and whose backward launches
the backward kernel (``flash_attention_bwd``: dq in q's dtype, dk and dv in
k's, three launches counted once in ``flash_attention_bwd.launches`` and
once under the variant in ``flash_attention_bwd.launches_by_impl``). Its
variants follow the forward's rule (``select_bwd_impl``; dout 16-byte
aligned as well): ``tc`` runs every product on bf16 tensor cores
with f32 sums, p and dS split into two bf16 terms; ``fp32`` (f32 or mixed
dtypes, other head dims, any alignment) runs every product on the tensor
cores through the forward's exact three-term split. On CPU tensors the
same Function runs ``flash_attention_plain`` and
``flash_attention_bwd_plain``. The reference has no backward kernel: it
differentiates its XLA scan, and the backward is held against ``jax.grad``
of that scan.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.obs import work

NEG_INF = -1e30
# the reference scan's chunks: Sq must split into min(512, Sq)-row query
# chunks and Sk into min(1024, Sk)-row kv chunks
Q_CHUNK, KV_CHUNK = 512, 1024
HD_MAX = 128  # the kernel's largest head dim (csrc/flash_attention.cu)
_DTYPES = (torch.float32, torch.bfloat16)
IMPLS = ("tc", "fp32")
_IMPL_CODE = {"fp32": 0, "tc": 1}


def select_impl(q, k, v) -> str:
    """The kernel variant for these (checked) inputs."""
    hd = q.shape[-1]
    if (all(t.dtype == torch.bfloat16 and work.aligned(t, 16)
            for t in (q, k, v)) and hd % 16 == 0):
        return "tc"
    return "fp32"


def select_bwd_impl(q, k, v, dout) -> str:
    """The backward kernel's variant for these (checked) inputs, dout in
    q's dtype: ``select_impl``'s rule, with dout 16-byte aligned as well
    (the tc passes read q, k, v and dout with 16-byte ``cp.async``; out
    is read only by the D pre-pass, element by element, in either
    variant)."""
    if select_impl(q, k, v) == "tc" and work.aligned(dout, 16):
        return "tc"
    return "fp32"


def _rate(q, k) -> str:
    """The rate of the products on q's and k's dtypes (``obs/work``)."""
    return work.flash_rate(q.dtype == torch.bfloat16,
                           k.dtype == torch.bfloat16)


def _scale(hd: int) -> float:
    """1 / sqrt(hd) in f32 arithmetic, as the reference and the kernel
    compute it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention_plain(q, k, v, *, causal: bool, q_offset: int = 0,
                          with_lse: bool = False):
    """Plain version: the reference's two-level scan with online softmax,
    query chunks of 512 rows and kv chunks of 1024 (skipping kv chunks
    wholly above the diagonal when there are at least 8, as the reference
    does; the result is the same either way). ``with_lse`` also returns
    each row's log-sum-exp m + log(max(l, 1e-30)), f32 (B, H, Sq)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    Tq, Ts = min(Q_CHUNK, Sq), min(KV_CHUNK, Sk)
    nq, nk = Sq // Tq, Sk // Ts
    scale = _scale(hd)
    dev = q.device
    qh = q.reshape(B, nq, Tq, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kh = k.reshape(B, nk, Ts, KV, hd).permute(1, 0, 3, 2, 4)
    vh = v.reshape(B, nk, Ts, KV, hd).permute(1, 0, 3, 2, 4)
    outs, lses = [], []
    for qi in range(nq):
        qb = qh[qi].to(torch.float32)  # (B, KV, G, Tq, hd)
        q_pos = q_offset + qi * Tq + torch.arange(Tq, device=dev)
        m = torch.full((B, KV, G, Tq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, Tq), device=dev)
        acc = torch.zeros((B, KV, G, Tq, hd), device=dev)
        for ki in range(nk):
            if causal and nk >= 8 and ki * Ts > q_offset + qi * Tq + Tq - 1:
                continue  # wholly masked chunk
            s = torch.einsum("bkgqh,bksh->bkgqs", qb,
                             kh[ki].to(torch.float32)) * scale
            if causal:
                k_pos = ki * Ts + torch.arange(Ts, device=dev)
                msk = k_pos[None, :] <= q_pos[:, None]  # (Tq, Ts)
                s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p, vh[ki].to(torch.float32))
            m = m_new
        den = torch.clamp(l, min=1e-30)
        outs.append(acc / den[..., None])
        lses.append(m + torch.log(den))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd)
    out = out.to(q.dtype).contiguous()
    if not with_lse:
        return out
    # (nq, B, KV, G, Tq) -> (B, H, Sq)
    lse = torch.stack(lses).permute(1, 2, 3, 0, 4).reshape(B, H, Sq)
    return out, lse.contiguous()


def _check(q, k, v, q_offset) -> None:
    """Raise ValueError on what neither the kernel nor the reference
    takes. The reference refuses Sq not a multiple of min(512, Sq) and Sk
    not a multiple of min(1024, Sk); the kernel also needs hd <= 128 with
    hd % 4 == 0, q_offset >= 0, f32/bf16 inputs (k and v of one dtype),
    contiguous, on one device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be 4-D")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != B
            or k.shape[3] != hd or KV < 1 or H % KV or Sq < 1 or Sk < 1):
        raise ValueError(f"flash_attention: inconsistent shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    if Sq % min(Q_CHUNK, Sq) or Sk % min(KV_CHUNK, Sk):
        raise ValueError(f"flash_attention: Sq={Sq} must be a multiple of "
                         f"{min(Q_CHUNK, Sq)} and Sk={Sk} of "
                         f"{min(KV_CHUNK, Sk)} (the reference's chunks)")
    if hd > HD_MAX or hd % 4:
        raise ValueError(f"flash_attention: head_dim {hd} (the kernel takes "
                         f"multiples of 4 up to {HD_MAX})")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset!r} must be "
                         "an int >= 0")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}")
    for name, t, dt in (("q", q, q.dtype), ("k", k, k.dtype),
                        ("v", v, k.dtype)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{dt} tensor on {q.device}")


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool,
                              q_offset: int = 0):
    """Plain version of the backward, in the kernel's formulation: with
    P = exp(scale q.k - lse) and D = rowsum(dout * out) (on the saved
    out), dv = P^T dout, dS = P (dout v^T - D), dq = scale dS k and
    dk = scale dS^T q, in f32 over the reference's 512-row query and
    1024-row kv chunks (kv chunks wholly above the diagonal skipped). dk
    and dv sum the G query heads of their kv head. Returns (dq, dk, dv) in
    q's, k's and k's dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    Tq, Ts = min(Q_CHUNK, Sq), min(KV_CHUNK, Sk)
    nq, nk = Sq // Tq, Sk // Ts
    scale = _scale(hd)
    dev = q.device
    f32 = torch.float32

    def q_chunks(t):  # (B, Sq, H, hd) -> (nq, B, KV, G, Tq, hd)
        return t.reshape(B, nq, Tq, KV, G, hd).permute(1, 0, 3, 4, 2, 5)

    qh, doh = q_chunks(q), q_chunks(dout)
    kh = k.reshape(B, nk, Ts, KV, hd).permute(1, 0, 3, 2, 4)
    vh = v.reshape(B, nk, Ts, KV, hd).permute(1, 0, 3, 2, 4)
    lse_h = lse.reshape(B, KV, G, nq, Tq).permute(3, 0, 1, 2, 4)
    delta = (dout.to(f32) * out.to(f32)).sum(dim=-1)  # (B, Sq, H)
    delta_h = delta.reshape(B, nq, Tq, KV, G).permute(1, 0, 3, 4, 2)
    dk = torch.zeros((nk, B, KV, Ts, hd), dtype=f32, device=dev)
    dv = torch.zeros((nk, B, KV, Ts, hd), dtype=f32, device=dev)
    dqs = []
    for qi in range(nq):
        qb, dob = qh[qi].to(f32), doh[qi].to(f32)  # (B, KV, G, Tq, hd)
        lse_b, d_b = lse_h[qi][..., None], delta_h[qi][..., None]
        q_pos = q_offset + qi * Tq + torch.arange(Tq, device=dev)
        dq = torch.zeros((B, KV, G, Tq, hd), dtype=f32, device=dev)
        for ki in range(nk):
            if causal and ki * Ts > q_offset + qi * Tq + Tq - 1:
                continue  # wholly masked chunk
            kb, vb = kh[ki].to(f32), vh[ki].to(f32)  # (B, KV, Ts, hd)
            s = torch.einsum("bkgqh,bksh->bkgqs", qb, kb) * scale
            if causal:
                k_pos = ki * Ts + torch.arange(Ts, device=dev)
                msk = k_pos[None, :] <= q_pos[:, None]
                s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lse_b)
            dv[ki] += torch.einsum("bkgqs,bkgqh->bksh", p, dob)
            ds = p * (torch.einsum("bkgqh,bksh->bkgqs", dob, vb) - d_b)
            dq += torch.einsum("bkgqs,bksh->bkgqh", ds, kb)
            dk[ki] += torch.einsum("bkgqs,bkgqh->bksh", ds, qb)
        dqs.append(dq * scale)
    dq = torch.stack(dqs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd)

    def kv_out(t):  # (nk, B, KV, Ts, hd) -> (B, Sk, KV, hd)
        return t.permute(1, 0, 3, 2, 4).reshape(B, Sk, KV, hd).to(
            k.dtype).contiguous()

    return dq.to(q.dtype).contiguous(), kv_out(dk * scale), kv_out(dv)


def _launch_forward(q, k, v, causal: bool, q_offset: int, lse=None):
    """One launch of the forward kernel on checked CUDA tensors; ``lse``
    (B, H, Sq) f32, when given, receives each row's log-sum-exp."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    impl = select_impl(q, k, v)
    fake = work.is_fake(q)
    if fake or work.active() is not None:
        work.kernel("flash_attention", impl, work.flash_attention_work(
            B, Sq, Sk, H, KV, hd, q_offset, causal, q.element_size(),
            _rate(q, k), lse is not None))
    if fake:  # the dry run: the kernel's outputs, nothing run
        return out
    fn = build.load("flash_attention").flash_attention_launch
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), int(k.dtype == torch.bfloat16), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, hd,
            int(bool(causal)), q_offset, _IMPL_CODE[impl],
            build.current_stream(q.device))
    build.check(rc, f"flash_attention ({impl})")
    flash_attention.launches += 1
    by_impl = flash_attention.launches_by_impl
    by_impl[impl] = by_impl.get(impl, 0) + 1
    return out


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool,
                        q_offset: int = 0):
    """(dq, dk, dv) of flash attention: the backward kernel on CUDA
    tensors (its variant by ``select_bwd_impl``; three launches: D, then
    dk/dv, then dq; one count, under the variant in ``launches_by_impl``),
    the plain version on CPU tensors. ``out`` and ``lse`` are the
    forward's; every tensor is checked on every device."""
    _check(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    for name, t, shape, dt in (("out", out, q.shape, q.dtype),
                               ("dout", dout, q.shape, q.dtype),
                               ("lse", lse, (B, H, Sq), torch.float32)):
        if (tuple(t.shape) != tuple(shape) or t.dtype != dt
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {dt} tensor of shape "
                             f"{tuple(shape)} on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal, q_offset=q_offset)
    Sk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    impl = select_bwd_impl(q, k, v, dout)
    fake = work.is_fake(q)
    if fake or work.active() is not None:
        work.kernel("flash_attention_bwd", impl,
                    work.flash_attention_bwd_work(
                        B, Sq, Sk, H, KV, hd, q_offset, causal,
                        q.element_size(), k.element_size(), _rate(q, k)))
    if fake:  # the dry run: the kernel's outputs, nothing run
        return dq, dk, dv
    fn = build.load("flash_attention").flash_attention_bwd_launch
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), int(k.dtype == torch.bfloat16), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, hd,
            int(bool(causal)), q_offset, _IMPL_CODE[impl],
            build.current_stream(q.device))
    build.check(rc, f"flash_attention_bwd ({impl})")
    flash_attention_bwd.launches += 1
    by_impl = flash_attention_bwd.launches_by_impl
    by_impl[impl] = by_impl.get(impl, 0) + 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_impl = {}  # variant -> launches


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention over checked inputs: the forward
    kernel with its log-sum-exp, and the backward kernel (CUDA tensors), or
    the two plain versions (CPU tensors). Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=q_offset, with_lse=True)
        else:
            B, Sq, H, _ = q.shape
            lse = torch.empty((B, H, Sq), dtype=torch.float32,
                              device=q.device)
            out = _launch_forward(q, k, v, causal, q_offset, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Flash attention; the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. Inputs are checked on every device, so CPU callers
    meet the kernel's contract too. When autograd records (grad mode on
    and an input requiring grad) the call always goes through
    ``FlashAttentionFn``, so the output carries its gradient on every
    device."""
    _check(q, k, v, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return _launch_forward(q, k, v, causal, q_offset)


flash_attention.launches = 0
flash_attention.launches_by_impl = {}  # variant (IMPLS) -> launches
