"""Port parity for the paper's baseline methods: uniform RTN and GPTQ
(``core/quant.py``), int-quant bit accounting, SVD codebook compression,
and the pipeline's ``IntQuant`` / ``kmeans`` / ``kmeans_data`` actions;
plus the property cases of ``tests/core/test_quant_core.py`` that need
these (GPTQ vs RTN, GPTVQ vs data-free k-means, d = 2 vs d = 1 at equal
bpv, the codebook update, SVD compression).

Inputs are numpy arrays from a seed handed to both packages; the
reference results are built once per module as numpy. Tolerances: RTN,
its integer codes and params, ``dequantize_int`` and ``int_quant_bpv``
bitwise; GPTQ's error within 1% and its Q on the same grid point (within
rtol 1e-5) on >= 99% of entries; the SVD permutation and remapped indices
bitwise; the VQ actions' errors within 2% (the sweep's bar).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpv as jbpv
from repro.core import codebook_compress as jcc
from repro.core import gptvq as jgptvq
from repro.core import hessian as jhes
from repro.core import pipeline as jpl
from repro.core import quant as jq
from repro.core import recipe as jrecipe

from repro_torch.core import bpv, quant as q, recipe
from repro_torch.core import codebook_compress as cc
from repro_torch.core import gptvq, hessian as hes
from repro_torch.core import pipeline as pl


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _problem(r=64, c=256, n=512, seed=0):
    """Weights + correlated calibration inputs, as numpy (the reference
    tests' make_problem recipe, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((r, c))
         * (1.0 + rng.uniform(size=(r, 1)))).astype(np.float32)
    A = rng.standard_normal((c, c)) / np.sqrt(c)
    X = (rng.standard_normal((n, c)) @ (np.eye(c) + 0.5 * A)).astype(np.float32)
    return W, X


def _err(W, Q, H):
    E = (np.asarray(W, np.float64) - np.asarray(Q, np.float64))
    return float(np.sum(E * (E @ np.asarray(H, np.float64))))


RTN_CASES = [(4, 32, False), (3, 64, False), (2, 128, False), (4, -1, False),
             (3, 48, False), (4, 32, True), (2, 128, True)]
GPTQ_CASES = [(4, 32, 64), (3, 128, 64), (4, 64, 32), (2, 128, 128),
              (3, 256, 64)]


@pytest.fixture(scope="module")
def ref():
    W, X = _problem()
    H = jhes.finalize(jhes.accumulate(jhes.init_hessian(X.shape[1]),
                                      jnp.asarray(X)))
    U = jhes.inv_hessian_cholesky(H)
    Wj = jnp.asarray(W)
    out = dict(W=W, H=np.asarray(H), U=np.asarray(U), rtn={}, gptq={})
    for bits, gs, sym in RTN_CASES:
        qi, p = jq.rtn_int_weights(Wj, bits, gs, sym)
        out["rtn"][(bits, gs, sym)] = dict(
            Q=np.asarray(jq.rtn_quantize(Wj, bits, gs, sym)),
            q=np.asarray(qi), scale=np.asarray(p.scale),
            zero=np.asarray(p.zero), gs=p.group_size,
            deq=np.asarray(jq.dequantize_int(qi, p)))
    for bits, gs, B in GPTQ_CASES:
        out["gptq"][(bits, gs, B)] = np.asarray(jq.gptq_quantize(
            Wj, U, bits=bits, group_size=gs, block_size=B))
    return out


@pytest.mark.parametrize("bits,gs,sym", RTN_CASES)
def test_rtn_and_int_codes_bitwise(ref, bits, gs, sym):
    want = ref["rtn"][(bits, gs, sym)]
    W = _t(ref["W"])
    assert np.array_equal(q.rtn_quantize(W, bits, gs, sym).numpy(), want["Q"])
    qi, p = q.rtn_int_weights(W, bits, gs, sym)
    assert qi.dtype == torch.int32 and p.group_size == want["gs"]
    assert np.array_equal(qi.numpy(), want["q"])
    assert np.array_equal(p.scale.numpy(), want["scale"])
    assert np.array_equal(p.zero.numpy(), want["zero"])
    assert np.array_equal(q.dequantize_int(qi, p).numpy(), want["deq"])


@pytest.mark.parametrize("bits,gs,B", GPTQ_CASES)
def test_gptq_matches_reference(ref, bits, gs, B):
    want = ref["gptq"][(bits, gs, B)]
    got = q.gptq_quantize(_t(ref["W"]), _t(ref["U"]), bits=bits,
                          group_size=gs, block_size=B).numpy()
    # the group params come from compensated weights whose f32 sums run in
    # another order, so a grid point can move by an ulp; a flipped rounding
    # would move it by a step
    same = np.isclose(got, want, rtol=1e-5, atol=1e-6).mean()
    assert same >= 0.99, same
    e_got, e_want = _err(ref["W"], got, ref["H"]), _err(ref["W"], want,
                                                        ref["H"])
    assert abs(e_got - e_want) <= 0.01 * e_want, (e_got, e_want)


@pytest.mark.parametrize("bits,gs,c", [(4, 128, 4096), (2, 128, 11008),
                                       (3, 64, 96), (4, -1, 256),
                                       (2, 100, 256), (4, None, 64)])
def test_int_quant_bpv_bitwise(bits, gs, c):
    assert bpv.int_quant_bpv(bits, gs, c) == jbpv.int_quant_bpv(bits, gs, c)


@pytest.mark.parametrize("d,b,oh,cb,sb", [(2, 2, 0.125, 8, 0),
                                          (1, 3, 0.125, 8, 0),
                                          (4, 2, 0.25, 8, 0),
                                          (2, 2, 0.25, 8, 64)])
def test_group_size_for_overhead_matches(d, b, oh, cb, sb):
    assert (bpv.group_size_for_overhead(d, b, oh, cb, sb)
            == jbpv.group_size_for_overhead(d, b, oh, cb, sb))


def test_gptq_identity_hessian_is_rtn_and_beats_rtn(ref):
    W, H, U = _t(ref["W"]), _t(ref["H"]), _t(ref["U"])
    Q1 = q.gptq_quantize(W, torch.eye(W.shape[1]), bits=4, group_size=64,
                         block_size=32)
    torch.testing.assert_close(Q1, q.rtn_quantize(W, 4, 64), rtol=0,
                               atol=1e-5)
    e_rtn = float(gptvq.layer_error(W, q.rtn_quantize(W, 3, 128), H))
    e_gptq = float(gptvq.layer_error(W, q.gptq_quantize(
        W, U, bits=3, group_size=128, block_size=64), H))
    assert e_gptq < 0.9 * e_rtn, (e_gptq, e_rtn)


# ---------------------------------------------------------------------------
# SVD codebook compression (1D VQ)
# ---------------------------------------------------------------------------

SVD_CFG = dict(d=1, bits_per_dim=3, group_size=512, em_iters=20,
               codebook_update_iters=0, svd_rank_frac=0.5)


@pytest.fixture(scope="module")
def svd_ref():
    W, X = _problem(r=32, c=256)
    H = jhes.finalize(jhes.accumulate(jhes.init_hessian(256), jnp.asarray(X)))
    U = jhes.inv_hessian_cholesky(H)
    res = jgptvq.gptvq_quantize_matrix(jnp.asarray(W), U,
                                       jbpv.VQConfig(**SVD_CFG))
    out, svd = jcc.svd_compress(res, jnp.asarray(W), H)
    a = res.arrays
    return dict(W=W, H=np.asarray(H),
                arrays={k: np.asarray(getattr(a, k)) for k in a._fields},
                cg=res.group_cols, rg=res.rows_per_band,
                perm=np.asarray(svd.perm),
                indices=np.asarray(out.arrays.indices),
                Q=np.asarray(out.arrays.Q), U=np.asarray(svd.U),
                err0=_err(W, a.Q, H), err=_err(W, out.arrays.Q, H))


def _port_result(ref_arrays, cfg, r, c, cg, rg):
    arrays = gptvq.VQArrays(**{k: _t(v) for k, v in ref_arrays.items()})
    return gptvq.VQResult(arrays=arrays, cfg=cfg, r=r, c=c, group_cols=cg,
                          rows_per_band=rg)


def test_svd_compress_matches_reference(svd_ref):
    W = svd_ref["W"]
    res = _port_result(svd_ref["arrays"], bpv.VQConfig(**SVD_CFG),
                       *W.shape, svd_ref["cg"], svd_ref["rg"])
    out, svd = cc.svd_compress(res, _t(W), _t(svd_ref["H"]))
    # the sort and the index remap are exact
    assert np.array_equal(svd.perm.numpy(), svd_ref["perm"])
    assert np.array_equal(out.arrays.indices.numpy(), svd_ref["indices"])
    assert svd.U.shape == svd_ref["U"].shape == (16, 4)
    # SVD factors are unique up to sign; C-hat = U V^T and the Adam steps
    # on it are not, so the compressed layer error agrees
    err = _err(W, out.arrays.Q.numpy(), svd_ref["H"])
    assert abs(err - svd_ref["err"]) <= 0.02 * svd_ref["err"], (
        err, svd_ref["err"])
    assert bool(torch.isfinite(out.arrays.Q).all())
    assert err < 10 * svd_ref["err0"] + 1e-6
    torch.testing.assert_close(out.reconstruct(), out.arrays.Q)


def test_svd_compress_refuses_2d():
    res = _port_result(
        {"Q": np.zeros((4, 8), np.float32),
         "indices": np.zeros((4, 4), np.int32),
         "codebooks": np.zeros((1, 1, 4, 2), np.float32),
         "scale_sint": np.zeros((1, 4, 1), np.int32),
         "scale_a": np.zeros((1,), np.float32),
         "scale_z": np.zeros((1,), np.float32)},
        bpv.VQConfig(d=2, bits_per_dim=1), 4, 8, 8, 4)
    with pytest.raises(ValueError, match="1D-VQ"):
        cc.svd_compress(res, torch.zeros(4, 8), torch.eye(8))


# ---------------------------------------------------------------------------
# the pipeline's baseline actions against the reference's _apply_action
# ---------------------------------------------------------------------------

VQ_KW = dict(em_iters=10, codebook_update_iters=0)
ACTIONS = {
    "kmeans": lambda R, S: R.Quantize(dataclasses.replace(
        S["2.125bpv_2d"], **VQ_KW), method="kmeans"),
    "kmeans_data": lambda R, S: R.Quantize(dataclasses.replace(
        S["2.125bpv_2d"], **VQ_KW), method="kmeans_data"),
    "gptvq": lambda R, S: R.Quantize(dataclasses.replace(
        S["2.125bpv_2d"], **VQ_KW)),
    "rtn": lambda R, S: R.IntQuant(bits=2, group_size=128, method="rtn"),
    "gptq": lambda R, S: R.IntQuant(bits=2, group_size=128),
}


@pytest.fixture(scope="module")
def action_ref():
    W, X = _problem(r=128, c=256, seed=4)
    H = jhes.finalize(jhes.accumulate(jhes.init_hessian(256), jnp.asarray(X)))
    W_io = jnp.asarray(W.T)  # the pipeline's (in, out) kernel
    out = dict(W=W, H=np.asarray(H), err={}, packed={}, q={})
    for name, make in ACTIONS.items():
        qio, packed = jpl._apply_action(
            W_io, H, make(jrecipe, jbpv.PAPER_SETTINGS),
            jax.random.PRNGKey(0))
        out["err"][name] = jpl._recon_error(W_io, qio, H)
        out["packed"][name] = packed is not None
        out["q"][name] = np.asarray(qio)
    return out


@pytest.mark.parametrize("name", list(ACTIONS))
def test_apply_action_matches_reference(action_ref, name):
    W, H = _t(action_ref["W"]), _t(action_ref["H"])
    action = ACTIONS[name](recipe, bpv.PAPER_SETTINGS)
    qio, packed = pl._apply_action(W.T.contiguous(), H, action)
    # only gptvq packs; the baselines leave a dense fake-quant leaf
    assert (packed is not None) == action_ref["packed"][name]
    assert tuple(qio.shape) == (256, 128)
    err = pl._recon_error(W.T, qio, H)
    want = action_ref["err"][name]
    if name == "rtn":
        assert np.array_equal(qio.numpy(), action_ref["q"][name])
    tol = 0.01 if name == "gptq" else 0.02
    assert abs(err - want) <= tol * want, (name, err, want)


def test_table1_ordering_on_correlated_inputs(action_ref):
    """Paper Table 1 on this problem: data-free k-means is worst, and
    GPTVQ's error feedback beats k-means with data; GPTQ beats RTN."""
    e = action_ref["err"]
    assert e["kmeans"] > e["kmeans_data"] > e["gptvq"], e
    assert e["gptq"] < e["rtn"], e


# ---------------------------------------------------------------------------
# property cases of tests/core/test_quant_core.py the port had not held
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prop_problem():
    W, X = _problem(r=64, c=256, seed=3)
    Xt = _t(X)
    H = hes.finalize(hes.accumulate(hes.init_hessian(256), Xt))
    return _t(W), H, hes.inv_hessian_cholesky(H)


def _vq(W, U, name, **kw):
    cfg = dataclasses.replace(bpv.PAPER_SETTINGS[name], **kw)
    return gptvq.gptvq_quantize_matrix(W, U, cfg)


def test_gptvq_beats_datafree_kmeans(prop_problem):
    W, H, U = prop_problem
    cfg = bpv.VQConfig(d=2, bits_per_dim=3, group_size=4096, em_iters=30,
                       codebook_update_iters=0)
    e_gptvq = float(gptvq.layer_error(
        W, gptvq.gptvq_quantize_matrix(W, U, cfg).arrays.Q, H))
    e_df = float(gptvq.layer_error(
        W, gptvq.gptvq_quantize_matrix(W, torch.eye(256), cfg).arrays.Q, H))
    assert e_gptvq < e_df, (e_gptvq, e_df)


def test_higher_d_better_sqnr_at_equal_bpv(prop_problem):
    W, H, U = prop_problem
    e = {name: float(gptvq.layer_error(W, _vq(
        W, U, name, em_iters=30, codebook_update_iters=0).arrays.Q, H))
        for name in ("2.25bpv_1d", "2.25bpv_2d")}
    assert e["2.25bpv_2d"] < e["2.25bpv_1d"], e


def test_codebook_update_reduces_error(prop_problem):
    W, H, U = prop_problem
    W, U, H = W[:32], U, H
    cfg = bpv.VQConfig(d=2, bits_per_dim=2, group_size=2048, em_iters=20,
                       codebook_update_iters=30)
    res = gptvq.gptvq_quantize_matrix(W, U, cfg)
    e0 = float(gptvq.layer_error(W, res.arrays.Q, H))
    e1 = float(gptvq.layer_error(W, cc.codebook_update(res, W, H).arrays.Q,
                                 H))
    assert e1 <= e0 * 1.001, (e0, e1)


@pytest.mark.parametrize("gs,B", [(32, 64), (128, 64), (64, 32)])
def test_gptq_group_block_combos(prop_problem, gs, B):
    W, H, U = prop_problem
    Q = q.gptq_quantize(W, U, bits=4, group_size=gs, block_size=B)
    assert bool(torch.isfinite(Q).all())
    assert float(gptvq.layer_error(W, Q, H)) < float(
        gptvq.layer_error(W, torch.zeros_like(W), H))
