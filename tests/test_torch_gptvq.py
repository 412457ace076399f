"""Port parity for GPTVQ on one matrix: Hessians and their Cholesky factors,
blockwise normalization, the Hessian-weighted assignment (against the JAX
Pallas kernel in interpret mode), EM codebooks with the deterministic
Mahalanobis seed, and the full sweep + codebook update + int8 codebooks.
Inputs are numpy arrays from a seed handed to both packages; the reference
results are built once per module as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codebook as jcb
from repro.core import codebook_compress as jcc
from repro.core import gptvq as jgptvq
from repro.core import hessian as jhes
from repro.core import normalization as jnorm
from repro.core.bpv import VQConfig as JVQConfig
from repro.kernels import ops as jops

from repro_torch.core import codebook as cb
from repro_torch.core import codebook_compress as cc
from repro_torch.core import gptvq, hessian as hes, normalization as norm
from repro_torch.core.bpv import VQConfig


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _problem(r=32, c=256, n=512, seed=0, dead=0):
    """Weights + correlated calibration inputs, as numpy (the reference
    tests' make_problem recipe, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((r, c))
         * (1.0 + rng.uniform(size=(r, 1)))).astype(np.float32)
    A = rng.standard_normal((c, c)) / np.sqrt(c)
    X = (rng.standard_normal((n, c)) @ (np.eye(c) + 0.5 * A)).astype(np.float32)
    if dead:
        X[:, :dead] = 0.0  # never-active input columns
    return W, X


@pytest.fixture(scope="module")
def hessians():
    out = {}
    for dead in (0, 16):
        _, X = _problem(dead=dead)
        half = X.shape[0] // 2
        st = jhes.init_hessian(X.shape[1])
        st = jhes.accumulate(st, jnp.asarray(X[:half]))
        st = jhes.accumulate(st, jnp.asarray(X[half:]))
        H = jhes.finalize(st)
        U = jhes.inv_hessian_cholesky(H)
        out[dead] = dict(X=X, H=np.asarray(H), U=np.asarray(U),
                         w=np.asarray(jhes.cholesky_diag_weights(U)))
    return out


@pytest.mark.parametrize("dead", [0, 16])
def test_hessian_cholesky_and_weights_match(hessians, dead):
    ref = hessians[dead]
    X = _t(ref["X"])
    st = hes.init_hessian(X.shape[1])
    st = hes.accumulate(st, X[: X.shape[0] // 2])
    st = hes.accumulate(st, X[X.shape[0] // 2:])
    assert st.n == X.shape[0]
    H = hes.finalize(st)
    # f32 sums of 512 products in another order
    np.testing.assert_allclose(H.numpy(), ref["H"], rtol=1e-5, atol=1e-5)
    # from the same H, so the Cholesky factors differ only by the two
    # LAPACK implementations' rounding (condition number ~1e2 here)
    U = hes.inv_hessian_cholesky(_t(ref["H"]))
    np.testing.assert_allclose(U.numpy(), ref["U"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hes.cholesky_diag_weights(U).numpy(),
                               ref["w"], rtol=2e-4)


def test_block_scales_match():
    W, _ = _problem()
    ref = jnorm.compute_block_scales(jnp.asarray(W), block=32, bits=4)
    bs = norm.compute_block_scales(_t(W), block=32, bits=4)
    # exact codes (rounding of log2 ratios away from .5 ties); a, z f32
    np.testing.assert_array_equal(bs.s_int.numpy(), np.asarray(ref.s_int))
    np.testing.assert_allclose(float(bs.a), float(ref.a), rtol=1e-6)
    np.testing.assert_allclose(float(bs.z), float(ref.z), rtol=1e-6)
    np.testing.assert_allclose(bs.expand(256).numpy(),
                               np.asarray(ref.expand(256)), rtol=1e-6)
    np.testing.assert_allclose(norm.normalize(_t(W), bs).numpy(),
                               np.asarray(jnorm.normalize(jnp.asarray(W), ref)),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def em_case():
    """Three bands of 128 2-d vectors with per-coordinate weights."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((3, 128, 2)).astype(np.float32)
    Hw = rng.uniform(0.2, 2.0, (128, 2)).astype(np.float32)
    C0 = rng.standard_normal((3, 16, 2)).astype(np.float32)
    init = jax.vmap(lambda xb: jcb.init_codebook(
        xb, jnp.asarray(Hw), k=16, iters=10))(jnp.asarray(X))
    seeds = jax.vmap(lambda xb: jcb.mahalanobis_init(xb, 16))(jnp.asarray(X))
    idx = np.stack([np.asarray(jops.assign(
        jnp.asarray(X[b]), jnp.asarray(Hw), jnp.asarray(C0[b]),
        use_pallas=True, interpret=True)) for b in range(3)])
    return dict(X=X, Hw=Hw, C0=C0, init=np.asarray(init),
                seeds=np.asarray(seeds), idx=idx)


def _chosen(X, Hw, C, idx):
    dist = ((Hw[None, :, None, :] * (X[:, :, None, :] - C[:, None]) ** 2)
            .sum(-1))
    return np.take_along_axis(dist, idx[..., None].astype(np.int64), 2)[..., 0]


def test_assign_matches_pallas_interpret_by_chosen_distance(em_case):
    e = em_case
    idx = cb.assign(_t(e["X"]), _t(e["Hw"]), _t(e["C0"])).numpy()
    assert idx.dtype == np.int32 and idx.shape == (3, 128)
    # argmin outputs: compare the chosen weighted distance, since a near-tie
    # may flip the index; f32 evaluations of the same sum agree to ~1e-6
    np.testing.assert_allclose(
        _chosen(e["X"], e["Hw"], e["C0"], idx),
        _chosen(e["X"], e["Hw"], e["C0"], e["idx"]), rtol=1e-5, atol=1e-6)


def test_mahalanobis_seed_and_em_codebooks_match(em_case):
    e = em_case
    seeds = cb.mahalanobis_init(_t(e["X"]), 16)
    # deterministic seed: stable argsort + round(linspace) picks the same
    # points, so the seeds are the same data rows
    np.testing.assert_array_equal(seeds.numpy(), e["seeds"])
    C = cb.init_codebook(_t(e["X"]), _t(e["Hw"]), k=16, iters=10)
    # 10 EM steps of f32 one-hot sums in another order
    np.testing.assert_allclose(C.numpy(), e["init"], rtol=1e-4, atol=1e-5)


MATRIX_CFGS = {
    "2d": dict(d=2, bits_per_dim=2, group_size=1024, em_iters=10,
               codebook_update_iters=5),
    "2d_sb32": dict(d=2, bits_per_dim=2, group_size=1024, em_iters=10,
                    codebook_update_iters=5, scale_block=32),
    "1d": dict(d=1, bits_per_dim=3, group_size=256, em_iters=10,
               codebook_update_iters=5),
}


@pytest.fixture(scope="module")
def matrix_refs(hessians):
    W, _ = _problem()
    H, U = hessians[0]["H"], hessians[0]["U"]
    out = {}
    for name, kw in MATRIX_CFGS.items():
        res = jgptvq.gptvq_quantize_matrix(jnp.asarray(W), jnp.asarray(U),
                                           JVQConfig(**kw))
        res = jcc.codebook_update(res, jnp.asarray(W), jnp.asarray(H))
        res = jcc.quantize_codebooks(res)
        out[name] = dict(
            Q=np.asarray(res.arrays.Q), idx=np.asarray(res.arrays.indices),
            err=float(jgptvq.layer_error(jnp.asarray(W), res.arrays.Q,
                                         jnp.asarray(H))),
            layout=(res.group_cols, res.rows_per_band))
    return W, H, U, out


@pytest.mark.parametrize("name", sorted(MATRIX_CFGS))
def test_quantize_matrix_matches_reference(matrix_refs, name):
    W, H, U, refs = matrix_refs
    ref = refs[name]
    cfg = VQConfig(**MATRIX_CFGS[name])
    res = gptvq.gptvq_quantize_matrix(_t(W), _t(U), cfg)
    assert (res.group_cols, res.rows_per_band) == ref["layout"]
    res = cc.codebook_update(res, _t(W), _t(H))
    res = cc.quantize_codebooks(res)
    err = float(gptvq.layer_error(_t(W), res.arrays.Q, _t(H)))
    # same algorithm in f32; a flipped near-tie feeds a different error into
    # the later columns, so the objective agrees within 2% and indices agree
    # everywhere but at such flips
    assert abs(err - ref["err"]) <= 0.02 * ref["err"], (err, ref["err"])
    agree = float((res.arrays.indices.numpy() == ref["idx"]).mean())
    assert agree >= 0.9, agree
    assert res.arrays.Q.shape == ref["Q"].shape


def test_sweep_without_feedback_is_plain_assignment():
    """With U = I (no error feedback) the sweep assigns every span to its
    nearest centroid under the Cholesky weights — a check of the sweep's
    bookkeeping independent of the reference."""
    W, _ = _problem(r=16, c=64)
    cfg = VQConfig(d=2, bits_per_dim=2, group_size=256, em_iters=5,
                   codebook_update_iters=0)
    res = gptvq.gptvq_quantize_matrix(_t(W), torch.eye(64), cfg)
    Qn = gptvq.gather_codebooks(res.arrays.codebooks, res.arrays.indices,
                                res.group_cols, res.rows_per_band, cfg.d)
    np.testing.assert_array_equal(Qn.numpy(), res.arrays.Q.numpy())
    cg, rg = res.group_cols, res.rows_per_band
    spans = _t(W).reshape(16 // rg, rg, 64 // cg, cg // 2, 2)
    C = res.arrays.codebooks  # (n_cg, n_bands, k, d)
    for g in range(64 // cg):
        for b in range(16 // rg):
            x = spans[b, :, g].reshape(-1, 2)
            dist = ((x[:, None] - C[g, b][None]) ** 2).sum(-1)
            got = res.arrays.indices.reshape(16 // rg, rg, 64 // cg,
                                             cg // 2)[b, :, g].reshape(-1)
            best = dist.min(-1).values
            chosen = dist.gather(1, got.long()[:, None])[:, 0]
            torch.testing.assert_close(chosen, best, rtol=1e-6, atol=1e-6)
