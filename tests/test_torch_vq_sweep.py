"""Port parity for the quantizer's two loops that run as one kernel launch
each on the card: one column group's d-span sweep with error feedback
(``kernels/vq_assign.vq_group_sweep``; on the CPU its plain loop) against
the reference's ``core/gptvq._group_sweep`` on the reference's own scales,
codebooks and U, and the EM codebook fit (``vq_em``) against the
reference's ``core/codebook.em``; then the wrappers' refusals, which come
before any launch, and CPU tensors, which touch no launch counter.
Inputs are numpy arrays from a seed handed to both packages; the reference
results are built once per module as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codebook as jcb
from repro.core import gptvq as jgptvq
from repro.core import hessian as jhes
from repro.core.bpv import VQConfig as JVQConfig

from repro_torch.core import gptvq
from repro_torch.core.bpv import VQConfig
from repro_torch.kernels import vq_assign as vqa


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


SWEEP_CFGS = {
    "2d": dict(d=2, bits_per_dim=2, group_size=1024, em_iters=10),
    "2d_sb32": dict(d=2, bits_per_dim=2, group_size=1024, em_iters=10,
                    scale_block=32),
    "2d_inexact": dict(d=2, bits_per_dim=2, group_size=1024, em_iters=10,
                       exact_span_solve=False),
    "1d": dict(d=1, bits_per_dim=3, group_size=256, em_iters=10),
}


@pytest.fixture(scope="module")
def sweep_refs():
    """One (32, 512) matrix of two 256-column groups, U from a correlated
    calibration sample; per config the reference's first-group init (scales,
    codebooks) and its sweep of that group with the tail update."""
    rng = np.random.default_rng(5)
    r, c, n = 32, 512, 1024
    W = (rng.standard_normal((r, c))
         * (1.0 + rng.uniform(size=(r, 1)))).astype(np.float32)
    A = rng.standard_normal((c, c)) / np.sqrt(c)
    X = (rng.standard_normal((n, c)) @ (np.eye(c) + 0.5 * A)).astype(np.float32)
    st = jhes.accumulate(jhes.init_hessian(c), jnp.asarray(X))
    U = jhes.inv_hessian_cholesky(jhes.finalize(st))
    wgt = jhes.cholesky_diag_weights(U)
    out = {}
    for name, kw in SWEEP_CFGS.items():
        cfg = JVQConfig(**kw)
        cg, rg = jgptvq.plan_groups(r, c, cfg)
        keys = jax.random.split(jax.random.PRNGKey(0), r // rg)
        Sg, _, _, _, Cg = jgptvq._group_init(
            jnp.asarray(W)[:, :cg], wgt[:cg], keys, cfg=cfg, group_cols=cg,
            rows_per_band=rg)
        W2, Qg, idxg = jgptvq._group_sweep(
            jnp.asarray(W), U, Sg, Cg, wgt[:cg], jnp.int32(0), cfg=cfg,
            group_cols=cg, rows_per_band=rg)
        out[name] = dict(Sg=np.asarray(Sg), Cg=np.asarray(Cg),
                         W=np.asarray(W2), Q=np.asarray(Qg),
                         idx=np.asarray(idxg), layout=(cg, rg))
    return W, np.asarray(U), np.asarray(wgt), out


@pytest.mark.parametrize("name", sorted(SWEEP_CFGS))
def test_group_sweep_matches_reference(sweep_refs, name):
    W0, U, wgt, refs = sweep_refs
    ref = refs[name]
    cfg = VQConfig(**SWEEP_CFGS[name])
    cg, rg = gptvq.plan_groups(*W0.shape, cfg)
    assert (cg, rg) == ref["layout"]
    W = _t(W0)
    before = (vqa.vq_group_sweep.launches, vqa.vq_assign.launches)
    Qg, idxg = gptvq._group_sweep(W, _t(U), _t(ref["Sg"]), _t(ref["Cg"]),
                                  _t(wgt[:cg]), 0, cfg=cfg, group_cols=cg,
                                  rows_per_band=rg)
    assert (vqa.vq_group_sweep.launches, vqa.vq_assign.launches) == before
    assert idxg.dtype == torch.int32 and idxg.shape == ref["idx"].shape
    same = idxg.numpy() == ref["idx"]
    # f32 sums in another order can flip a near-tie, which then feeds a
    # different error into that row's later columns
    assert same.mean() >= 0.99, same.mean()
    rows = same.all(axis=1)
    assert rows.mean() >= 0.75, rows.mean()
    # where a row's indices all agree its Q, its group columns (left as
    # each was quantized) and its tail (the lazy update) agree to f32
    # rounding of the same sums
    np.testing.assert_allclose(Qg.numpy()[rows], ref["Q"][rows], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(W.numpy()[rows], ref["W"][rows], rtol=1e-5,
                               atol=1e-5)


def test_group_sweep_plain_updates_a_column_slice_in_place(sweep_refs):
    """The wrapper takes the group as a strided column slice of the whole
    matrix and leaves the columns outside it alone."""
    W0, U, wgt, refs = sweep_refs
    ref = refs["2d"]
    cg, rg = ref["layout"]
    W = _t(W0)
    Qg, idxg, Eg = vqa.vq_group_sweep(
        W[:, :cg], _t(U)[:cg, :cg], _t(ref["Sg"]), _t(ref["Cg"]),
        _t(wgt[:cg]), d=2, rows_per_band=rg, exact_span_solve=True)
    np.testing.assert_array_equal(W.numpy()[:, cg:], W0[:, cg:])
    assert Eg.shape == Qg.shape == (W0.shape[0], cg)
    # the sweep's outputs are its inputs' bookkeeping: Q = S * C[idx]
    Qn = gptvq.gather_codebooks(_t(ref["Cg"])[None], idxg, cg, rg, 2)
    np.testing.assert_array_equal((Qn * _t(ref["Sg"])).numpy(), Qg.numpy())


@pytest.fixture(scope="module")
def em_refs():
    """Four bands of 512 2-d points (the quantizer's 2.25bpv_2d bands), the
    reference's Mahalanobis seeds, and its EM at 10 iterations with shared
    and with per-band weights."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((4, 512, 2)).astype(np.float32)
    X[1] *= np.float32(0.01)  # a band of small values
    hw_shared = rng.uniform(0.2, 2.0, (512, 2)).astype(np.float32)
    hw_band = rng.uniform(0.2, 2.0, (4, 512, 2)).astype(np.float32)
    C0 = np.array(jax.vmap(lambda xb: jcb.mahalanobis_init(xb, 16))(
        jnp.asarray(X)))
    C0[2, 3] = 50.0  # a centroid no point picks keeps its seed
    shared = jax.vmap(lambda xb, cb: jcb.em(xb, jnp.asarray(hw_shared), cb,
                                            iters=10))(jnp.asarray(X),
                                                       jnp.asarray(C0))
    band = jax.vmap(lambda xb, hb, cb: jcb.em(xb, hb, cb, iters=10))(
        jnp.asarray(X), jnp.asarray(hw_band), jnp.asarray(C0))
    return dict(X=X, C0=C0, hw={"shared": hw_shared, "band": hw_band},
                C={"shared": np.asarray(shared), "band": np.asarray(band)})


@pytest.mark.parametrize("hw", ["shared", "band"])
def test_em_matches_reference(em_refs, hw):
    e = em_refs
    before = (vqa.vq_em.launches, vqa.vq_assign.launches)
    C = vqa.vq_em(_t(e["X"]), _t(e["hw"][hw]), _t(e["C0"]), 10)
    assert (vqa.vq_em.launches, vqa.vq_assign.launches) == before
    assert C.shape == (4, 16, 2) and C.dtype == torch.float32
    # 10 EM steps of f32 one-hot sums in another order
    np.testing.assert_allclose(C.numpy(), e["C"][hw], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(C.numpy()[2, 3], e["C0"][2, 3])


def test_em_with_no_iterations_returns_the_seeds(em_refs):
    e = em_refs
    C = vqa.vq_em(_t(e["X"]), _t(e["hw"]["shared"]), _t(e["C0"]), 0)
    np.testing.assert_array_equal(C.numpy(), e["C0"])


def _sweep_inputs(r=8, cg=16, d=2, k=4, rg=4):
    g = torch.Generator().manual_seed(0)
    return dict(Wg=torch.randn((r, cg), generator=g),
                Ug=torch.eye(cg), Sg=torch.ones((r, cg)),
                Cg=torch.randn((r // rg, k, d), generator=g),
                wgt_g=torch.ones(cg)), dict(d=d, rows_per_band=rg,
                                            exact_span_solve=True)


SWEEP_REFUSALS = [
    (lambda t, kw: (dict(t, Wg=t["Wg"][None]), kw), "must be \\(r, cg\\)"),
    (lambda t, kw: (t, dict(kw, d=5)), "1 <= d <= 4"),
    (lambda t, kw: (t, dict(kw, rows_per_band=3)), "bands of 3"),
    (lambda t, kw: (dict(t, Wg=t["Wg"][:, :15]), kw), "spans of 2"),
    (lambda t, kw: (dict(t, Ug=t["Ug"][:8, :8]), kw), "do not fit"),
    (lambda t, kw: (dict(t, Cg=t["Cg"][:1]), kw), "do not fit"),
    (lambda t, kw: (dict(t, Cg=t["Cg"][..., :1]), kw), "do not fit"),
    (lambda t, kw: (dict(t, wgt_g=t["wgt_g"][:8]), kw), "do not fit"),
    (lambda t, kw: (dict(t, Sg=t["Sg"].double()), kw), "float32"),
    (lambda t, kw: (dict(t, Wg=t["Wg"].t().contiguous().t()), kw),
     "unit column stride"),
    (lambda t, kw: (dict(t, Cg=t["Cg"].transpose(1, 2).contiguous()
                         .transpose(1, 2)), kw), "contiguous"),
]


@pytest.mark.parametrize("case,match", SWEEP_REFUSALS)
def test_sweep_wrapper_raises_before_any_launch(case, match):
    t, kw = case(*_sweep_inputs())
    before = vqa.vq_group_sweep.launches
    with pytest.raises(ValueError, match=match):
        vqa.vq_group_sweep(**t, **kw)
    assert vqa.vq_group_sweep.launches == before


def _em_inputs(B=3, n=10, d=2, k=4):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((B, n, d), generator=g), torch.ones((n, d)),
            torch.randn((B, k, d), generator=g))


EM_REFUSALS = [
    (lambda X, Hw, C0: (X[0], Hw, C0, 2), "must be \\(B, n, d\\)"),
    (lambda X, Hw, C0: (X, Hw, C0[:2], 2), "1 <= d <= 4"),
    (lambda X, Hw, C0: (torch.zeros((3, 10, 5)), torch.ones((10, 5)),
                        torch.zeros((3, 4, 5)), 2), "1 <= d <= 4"),
    (lambda X, Hw, C0: (X, Hw, C0, -1), "iters"),
    (lambda X, Hw, C0: (X, Hw, C0, 2.0), "iters"),
    (lambda X, Hw, C0: (X, Hw[:9], C0, 2), "Hw"),
    (lambda X, Hw, C0: (X.double(), Hw, C0, 2), "float32"),
    (lambda X, Hw, C0: (X.transpose(0, 1).contiguous().transpose(0, 1), Hw,
                        C0, 2), "contiguous"),
    (lambda X, Hw, C0: (torch.zeros((1, 4, 4)), torch.ones((4, 4)),
                        torch.zeros((1, 13000, 4)), 2), "shared memory"),
]


@pytest.mark.parametrize("case,match", EM_REFUSALS)
def test_em_wrapper_raises_before_any_launch(case, match):
    args = case(*_em_inputs())
    before = vqa.vq_em.launches
    with pytest.raises(ValueError, match=match):
        vqa.vq_em(*args)
    assert vqa.vq_em.launches == before


def test_cpu_tensors_touch_no_kernel_counter():
    counters = lambda: (vqa.vq_assign.launches, vqa.vq_group_sweep.launches,
                        vqa.vq_em.launches)
    before = counters()
    t, kw = _sweep_inputs()
    vqa.vq_group_sweep(**t, **kw)
    X, Hw, C0 = _em_inputs()
    vqa.vq_em(X, Hw, C0, 3)
    vqa.vq_assign(X, Hw, C0)
    assert counters() == before
