"""Port parity for ``models/ssm.py``, the Mamba2 (SSD) mixer of the hybrid
family, on the ``zamba2-7b`` smoke widths (f32: d_model 64, d_inner 128, 8
SSM heads of 16, state 16, conv width 4):

* ``_ssd_chunked`` against the reference's, and against the sequential
  ``ssd_reference`` (the port's and the reference's), in one chunk and in
  four;
* ``pre_out`` / ``apply`` with and without a cache, against the
  reference's on its own weights;
* a chunked prefill in two calls (the second resuming from the first's
  ``h0``) against one call;
* S = 1 decode steps (the recurrent branch) against the prefill's rows;
* the conv state the cache carries.

All at atol 1e-5 (f32 sums in another order). The reference's outputs are
computed once for the module, as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import ssm as jssm

from repro_torch.configs import SMOKE
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(pkg):
    return (JSMOKE if pkg == "ref" else SMOKE)["zamba2-7b"].scaled(
        dtype="float32")


def _scan_inputs(seed: int, S_: int):
    cfg = _cfg("port")
    _, heads, _ = ssm._dims(cfg)
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S_, heads, cfg.ssm_head_dim))
    Bm = rng.standard_normal((B, S_, cfg.ssm_state))
    Cm = rng.standard_normal((B, S_, cfg.ssm_state))
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, heads)) - 1.0))
    A = -np.exp(np.log(np.linspace(1.0, 16.0, heads)))
    return [a.astype(np.float32) for a in (xh, Bm, Cm, dt, A)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref():
    """The reference's scans, mixer outputs and cache states on numpy
    inputs and its own weights."""
    cfg = _cfg("ref")
    out = {}
    for chunk in (S, S // 4):
        ins = _scan_inputs(chunk, S)
        y, h = jssm._ssd_chunked(*map(jnp.asarray, ins), chunk)
        out[f"chunked {chunk}"] = (ins, np.asarray(y), np.asarray(h))
    ins = _scan_inputs(7, S)
    y, h = jssm.ssd_reference(*map(jnp.asarray, ins))
    out["sequential"] = (ins, np.asarray(y), np.asarray(h))

    p = jssm.init(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pre, _ = jssm.pre_out(p, cfg, jnp.asarray(x))
    y_nc, _ = jssm.apply(p, cfg, jnp.asarray(x))
    y_c, c = jssm.apply(p, cfg, jnp.asarray(x), jssm.init_cache(cfg, B))
    out["params"] = jax.tree.map(np.asarray, p)
    out["x"] = x
    out["pre_out"] = np.asarray(pre)
    out["apply"] = np.asarray(y_nc)
    out["apply cached"] = (np.asarray(y_c), np.asarray(c.h),
                           np.asarray(c.conv))
    # one decode step after the cached prefill
    x1 = np.random.default_rng(2).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    y1, c1 = jssm.apply(p, cfg, jnp.asarray(x1), c)
    out["decode"] = (x1, np.asarray(y1), np.asarray(c1.h),
                     np.asarray(c1.conv))
    return out


def _port_params(ref):
    return {k: _t(v) for k, v in ref["params"].items()}


@pytest.mark.parametrize("chunk", [S, S // 4])
def test_ssd_chunked_matches_reference(ref, chunk):
    """One chunk (Q = S) and four (Q = S / 4, the inter-chunk recurrence)."""
    ins, y_ref, h_ref = ref[f"chunked {chunk}"]
    y, h = ssm._ssd_chunked(*map(_t, ins), chunk)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(h.numpy(), h_ref, **TOL)


@pytest.mark.parametrize("chunk", [S, S // 4])
def test_ssd_chunked_matches_sequential_oracle(ref, chunk):
    """The chunked scan against the sequential recurrence, both the port's
    oracle and the reference's."""
    ins, y_ref, h_ref = ref["sequential"]
    y, h = ssm._ssd_chunked(*map(_t, ins), chunk)
    y_seq, h_seq = ssm.ssd_reference(*map(_t, ins))
    for got in ((y, h), (y_seq, h_seq)):
        np.testing.assert_allclose(got[0].numpy(), y_ref, **TOL)
        np.testing.assert_allclose(got[1].numpy(), h_ref, **TOL)


def test_pre_out_and_apply_without_cache(ref):
    cfg = _cfg("port")
    p, x = _port_params(ref), _t(ref["x"])
    pre, c = ssm.pre_out(p, cfg, x)
    assert c is None
    np.testing.assert_allclose(pre.numpy(), ref["pre_out"], **TOL)
    y, c = ssm.apply(p, cfg, x)
    assert c is None
    np.testing.assert_allclose(y.numpy(), ref["apply"], **TOL)


def test_apply_with_cache_and_conv_state(ref):
    """A cached prefill gives the uncached output, the reference's final
    state, and the conv state of the last w - 1 conv inputs."""
    cfg = _cfg("port")
    p, x = _port_params(ref), _t(ref["x"])
    y, c = ssm.apply(p, cfg, x, ssm.init_cache(cfg, B))
    y_ref, h_ref, conv_ref = ref["apply cached"]
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(c.h.numpy(), h_ref, **TOL)
    np.testing.assert_allclose(c.conv.numpy(), conv_ref, **TOL)
    assert c.h.dtype == torch.float32
    # the conv state is the tail of the [x|B|C] conv inputs
    proj = x @ p["in_proj"]
    d_inner = cfg.ssm_expand * cfg.d_model
    u = proj[..., d_inner:2 * d_inner + 2 * cfg.ssm_state]
    np.testing.assert_allclose(c.conv.numpy(),
                               u[:, -(cfg.ssm_conv_width - 1):].numpy(),
                               **TOL)


def test_decode_step_matches_reference(ref):
    """The S = 1 recurrent branch after a cached prefill."""
    cfg = _cfg("port")
    p = _port_params(ref)
    _, c = ssm.apply(p, cfg, _t(ref["x"]), ssm.init_cache(cfg, B))
    x1, y_ref, h_ref, conv_ref = ref["decode"]
    y1, c1 = ssm.apply(p, cfg, _t(x1), c)
    np.testing.assert_allclose(y1.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(c1.h.numpy(), h_ref, **TOL)
    np.testing.assert_allclose(c1.conv.numpy(), conv_ref, **TOL)


@pytest.mark.parametrize("split", [4, 8, 12])
def test_chunked_prefill_resumes_from_h0(ref, split):
    """Two cached calls (the second from the first's state and conv
    inputs) give the rows and the final state of one call."""
    cfg = _cfg("port")
    p, x = _port_params(ref), _t(ref["x"])
    y_all, c_all = ssm.apply(p, cfg, x, ssm.init_cache(cfg, B))
    y_a, c_a = ssm.apply(p, cfg, x[:, :split], ssm.init_cache(cfg, B))
    y_b, c_b = ssm.apply(p, cfg, x[:, split:], c_a)
    np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(),
                               y_all.numpy(), **TOL)
    np.testing.assert_allclose(c_b.h.numpy(), c_all.h.numpy(), **TOL)
    np.testing.assert_allclose(c_b.conv.numpy(), c_all.conv.numpy(), **TOL)


def test_decode_steps_match_prefill_rows(ref):
    """S = 1 steps from a reset cache, token by token, give the rows of
    the one-call prefill (the recurrent branch against the chunked scan)."""
    cfg = _cfg("port")
    p, x = _port_params(ref), _t(ref["x"])
    y_all, c_all = ssm.apply(p, cfg, x, ssm.init_cache(cfg, B))
    c = ssm.init_cache(cfg, B)
    rows = []
    for t in range(S):
        y, c = ssm.apply(p, cfg, x[:, t:t + 1], c)
        rows.append(y)
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), y_all.numpy(),
                               **TOL)
    np.testing.assert_allclose(c.h.numpy(), c_all.h.numpy(), **TOL)
    np.testing.assert_allclose(c.conv.numpy(), c_all.conv.numpy(), **TOL)


def test_head_blocks_change_nothing(ref, monkeypatch):
    """The decay tiles built a block of heads at a time (the bound the
    card's memory sets at full width) give the all-heads result."""
    ins, _, _ = ref[f"chunked {S // 4}"]
    y, h = ssm._ssd_chunked(*map(_t, ins), S // 4)
    monkeypatch.setattr(ssm, "_DECAY_ELEMS", B * 4 * (S // 4) ** 2 * 3)
    y3, h3 = ssm._ssd_chunked(*map(_t, ins), S // 4)
    assert torch.equal(y, y3) and torch.equal(h, h3)
