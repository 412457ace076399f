"""Flash attention's backward in the port against the reference.

The reference has no backward kernel: it differentiates its XLA two-level
scan (``repro.models.attention.flash_attention``) with ``jax.grad``. The
port's ``flash_attention_bwd_plain`` (the LSE / D formulation of the CUDA
backward kernel) and ``FlashAttentionFn``'s CPU backward are held to that
gradient and to autograd through the port's own plain scan, at Sq 1024 and
2048 over Sk 2048, causal and not, GQA, a q_offset, f32: rtol 1e-5, atol
1e-6 * max|g|. The reference's gradients are built once per module, as
numpy. Also: the wrapper always goes through the Function when autograd
records, and the forward's log-sum-exp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa

# (B, Sq, Sk, H, KV, hd, causal, q_offset)
CASES = {
    "causal": (1, 2048, 2048, 2, 2, 16, True, 0),
    "non-causal gqa": (1, 1024, 2048, 4, 2, 16, False, 0),
    "q_offset gqa": (1, 1024, 2048, 4, 1, 32, True, 1024),
    "causal gqa b2": (2, 1024, 2048, 2, 1, 16, True, 512),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def inputs(case: str):
    B, Sq, Sk, H, KV, hd, causal, off = CASES[case]
    rng = np.random.default_rng(Sq + Sk + H + hd)
    q, dout = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v, dout, causal, off


@pytest.fixture(scope="module")
def reference():
    """Per case: the scan's output and jax.grad of <out, dout> wrt q, k, v."""
    out = {}
    for case in CASES:
        q, k, v, dout, causal, off = inputs(case)

        def f(q, k, v):
            o = jattn.flash_attention(q, k, v, causal=causal, q_offset=off)
            return jnp.sum(o * dout), o

        (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out[case] = (np.asarray(o), tuple(np.asarray(x) for x in g))
    return out


def assert_grads(got, want):
    for a, b in zip(got, want):
        b = torch.as_tensor(b)
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_the_scan(reference, case):
    q, k, v, dout, causal, off = (torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x for x in inputs(case))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        q_offset=off, with_lse=True)
    o_ref, g_ref = reference[case]
    torch.testing.assert_close(out, torch.from_numpy(o_ref.copy()),
                               rtol=1e-5, atol=1e-6)
    got = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                       causal=causal, q_offset=off)
    assert_grads(got, g_ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_backward_matches_jax_grad_and_plain_autograd(reference,
                                                               case):
    q0, k0, v0, dout, causal, off = (torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x for x in inputs(case))
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        o = fn(q, k, v, causal=causal, q_offset=off)
        (o * dout).sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    assert_grads(grads[0], reference[case][1])
    assert_grads(grads[0], grads[1])


def test_grad_mode_always_goes_through_the_function():
    """A call that autograd records can never take the kernel's (or the
    plain version's) ungraded path: its output's grad_fn is the
    Function's, for any input requiring grad; outside grad mode there is
    none."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 256, 2, 16)).astype(np.float32)) for _ in range(3))
    for which in range(3):
        args = [q, k, v]
        args[which] = args[which].clone().requires_grad_(True)
        o = fa.flash_attention(*args, causal=True)
        assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
        with torch.no_grad():
            assert fa.flash_attention(*args, causal=True).grad_fn is None
    assert fa.flash_attention(q, k, v, causal=True).grad_fn is None


def test_function_casts_gradients_to_each_input_dtype():
    """bf16 q with f32 k/v (and the reverse): dq in q's dtype, dk and dv in
    k's; the same values as the f32 computation rounded once."""
    rng = np.random.default_rng(1)
    q0, k0, v0, w = (torch.from_numpy(rng.standard_normal(
        (1, 512, 4, 32)).astype(np.float32)) for _ in range(4))
    k0, v0 = k0[:, :, :2].contiguous(), v0[:, :, :2].contiguous()
    for q_dt, kv_dt in ((torch.bfloat16, torch.float32),
                        (torch.float32, torch.bfloat16)):
        q = q0.to(q_dt).clone().requires_grad_(True)
        k, v = (t.to(kv_dt).clone().requires_grad_(True) for t in (k0, v0))
        o = fa.flash_attention(q, k, v, causal=True)
        assert o.dtype == q_dt
        (o.float() * w).sum().backward()
        assert (q.grad.dtype, k.grad.dtype, v.grad.dtype) == (
            q_dt, kv_dt, kv_dt)
        out, lse = fa.flash_attention_plain(q.detach(), k.detach(),
                                            v.detach(), causal=True,
                                            with_lse=True)
        want = fa.flash_attention_bwd_plain(
            q.detach().float(), k.detach().float(), v.detach().float(),
            out.float(), w.to(q_dt).float(), lse, causal=True)
        for got, ref in zip((q.grad, k.grad, v.grad), want):
            torch.testing.assert_close(got, ref.to(got.dtype), rtol=0,
                                       atol=0)


def test_lse_is_the_scans_log_sum_exp():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 1024, 2, 16)).astype(np.float32)) for _ in range(3))
    _, lse = fa.flash_attention_plain(q, k, v, causal=True, q_offset=0,
                                      with_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * fa._scale(16)
    s = s.masked_fill(torch.ones((1024, 1024), dtype=torch.bool).triu(1),
                      float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-6,
                               atol=1e-5)


def test_backward_checks_its_inputs():
    q = torch.zeros((1, 64, 2, 16))
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, q, lse[:, :1], causal=True)
    with pytest.raises(ValueError, match="out"):
        fa.flash_attention_bwd(q, q, q, q.to(torch.bfloat16), q, lse,
                               causal=True)


def _bwd_args(q_dt, kv_dt, hd, misaligned=None):
    """Zeros of the backward's shapes (B 1, Sq = Sk = 128, H 4, KV 2);
    the tensor named by ``misaligned`` ("out" or "dout") one element into
    a larger buffer."""
    def q_like(name):
        off = int(name == misaligned)
        n = 128 * 4 * hd
        return torch.zeros(n + off, dtype=q_dt)[off:].view((1, 128, 4, hd))

    q, out, dout = q_like("q"), q_like("out"), q_like("dout")
    k, v = (torch.zeros((1, 128, 2, hd), dtype=kv_dt) for _ in range(2))
    lse = torch.zeros((1, 4, 128))
    return q, k, v, out, dout, lse


@pytest.mark.parametrize("q_dt,kv_dt,hd,misaligned,impl", [
    (torch.bfloat16, torch.bfloat16, 64, None, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, None, "tc"),
    (torch.bfloat16, torch.bfloat16, 36, None, "fp32"),  # hd % 16 != 0
    (torch.float32, torch.float32, 64, None, "fp32"),
    (torch.bfloat16, torch.float32, 64, None, "fp32"),
    (torch.float32, torch.bfloat16, 64, None, "fp32"),
    (torch.bfloat16, torch.bfloat16, 64, "dout", "fp32"),  # 2 bytes off
    (torch.bfloat16, torch.bfloat16, 64, "out", "tc"),  # read by D only
])
def test_backward_variant_rule(q_dt, kv_dt, hd, misaligned, impl):
    """The backward's variant follows the forward's rule (q, k, v bf16 and
    16-byte aligned, hd a multiple of 16), with dout 16-byte aligned as
    well; out's alignment does not matter (only the D pre-pass reads it,
    element by element). The rule reads the inputs only, so it holds on
    CPU tensors."""
    q, k, v, out, dout, lse = _bwd_args(q_dt, kv_dt, hd, misaligned)
    for name, t in (("out", out), ("dout", dout)):
        assert t.is_contiguous()
        assert (t.data_ptr() % 16 != 0) == (name == misaligned)
    assert fa.select_bwd_impl(q, k, v, dout) == impl


def test_backward_on_the_cpu_runs_the_plain_version():
    """A CPU call runs flash_attention_bwd_plain, bit for bit, and touches
    neither launch count, for inputs that would pick either variant on
    the card."""
    rng = np.random.default_rng(3)
    for dt, hd in ((torch.bfloat16, 64), (torch.float32, 36)):
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            (1, 256, 2, hd)).astype(np.float32)).to(dt) for _ in range(4))
        out, lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            with_lse=True)
        launches = fa.flash_attention_bwd.launches
        by_impl = dict(fa.flash_attention_bwd.launches_by_impl)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                            causal=True)
        assert fa.flash_attention_bwd.launches == launches
        assert fa.flash_attention_bwd.launches_by_impl == by_impl
        for a, b in zip(got, want):
            assert a.dtype == dt and torch.equal(a, b)
