"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's (``repro.train.optimizer``) on the same numpy trees: the
schedule at every step, ``update`` on a mixed tree (2-D, 1-D, a stacked
layer leaf and its unstacked list form, bf16 params, bf16 moments),
clipping and ``global_norm``, weight decay by the reference's rank, and
mirrors of the reference's ``TestOptimizer``.

Bars: the schedule within rtol 1e-6; params, m, v and master within rtol
1e-6 and atol 1e-7 (f32 arithmetic in the same order; pow, sqrt and cos
may differ by an ulp between XLA and torch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as opt

CFG = dict(lr=3e-2, warmup_steps=3, total_steps=12, weight_decay=0.1,
           clip_norm=1.0)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree, dtype=None):
    """numpy tree (dicts of arrays, lists) -> torch (f32 via numpy, then
    ``dtype`` or the array's own: bf16 arrays stay bf16)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v, dtype) for v in tree]
    a = np.asarray(tree)
    dt = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                   else torch.float32)
    return torch.from_numpy(a.astype(np.float32)).to(dt)


def close(got, want, rtol=1e-6, atol=1e-7):
    torch.testing.assert_close(got.float(), to_torch(want).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", range(0, 15))
def test_schedule_matches_reference_at_every_step(step):
    cfg, jcfg = opt.OptConfig(**CFG), jopt.OptConfig(**CFG)
    got = float(opt.schedule(cfg, torch.tensor(step)))
    want = float(jopt.schedule(jcfg, jnp.asarray(step)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def mixed_tree(seed: int):
    """A 2-D, a 1-D and a 3-D (expert-stack-like) leaf, and a small stack of
    layers: the reference's stacked (2, ...) leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "norm": (1 + 0.1 * rng.standard_normal(5)).astype(np.float32),
            "experts": rng.standard_normal((3, 4, 2)).astype(np.float32),
            "layers": {
                "wq": rng.standard_normal((2, 5, 5)).astype(np.float32),
                "norm1": rng.standard_normal((2, 5)).astype(np.float32)}}


def unstack(tree):
    """The port's form: ``layers`` a list of per-layer dicts."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    n = next(iter(tree["layers"].values())).shape[0]
    out["layers"] = [{k: v[i] for k, v in tree["layers"].items()}
                     for i in range(n)]
    return out


def run_both(moment_dtype: str, param_dtype, steps: int = 4,
             grad_scale: float = 1.0):
    """``steps`` updates in both packages on the same numpy gradients;
    returns (port params, port state, ref params (port form), ref state
    (port form)), each step's metrics."""
    kw = dict(CFG, moment_dtype=moment_dtype)
    cfg, jcfg = opt.OptConfig(**kw), jopt.OptConfig(**kw)
    p0 = mixed_tree(0)
    jdt = None if param_dtype is None else jnp.bfloat16
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt or jnp.float32), p0)
    js = jopt.init(jp, jcfg)
    tp = to_torch(unstack(np_tree(jp)))
    ts = opt.init(tp, cfg)
    metrics = []
    for i in range(steps):
        g = jax.tree.map(lambda a: (grad_scale * a).astype(np.float32),
                         mixed_tree(100 + i))
        jp, js, jm = jopt.update(jcfg, jax.tree.map(jnp.asarray, g), js,
                                 param_dtype=jdt)
        tp, ts, tm = opt.update(cfg, to_torch(unstack(g)), ts,
                                param_dtype=param_dtype, stacked_layers=True)
        metrics.append((tm, jm))
    ref = {"params": unstack(np_tree(jp)), "m": unstack(np_tree(js.m)),
           "v": unstack(np_tree(js.v)),
           "master": unstack(np_tree(js.master)), "step": int(js.step)}
    return tp, ts, ref, metrics


def check_tree(got, want, **tol):
    got_l, want_l = opt.tree_leaves(got), opt.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert tuple(a.shape) == tuple(np.shape(b))
        close(a, b, **tol)


@pytest.mark.parametrize("moment_dtype,param_dtype", [
    ("float32", None), ("float32", torch.bfloat16),
    ("bfloat16", torch.bfloat16)])
def test_update_matches_reference_on_a_mixed_tree(moment_dtype, param_dtype):
    tp, ts, ref, metrics = run_both(moment_dtype, param_dtype)
    assert int(ts.step) == ref["step"] == 4
    mdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    assert all(t.dtype == mdt for t in opt.tree_leaves(ts.m))
    assert all(t.dtype == torch.float32 for t in opt.tree_leaves(ts.master))
    want_pdt = param_dtype or torch.float32
    assert all(t.dtype == want_pdt for t in opt.tree_leaves(tp))
    # bf16 moments and params are the f32 values rounded once: compare
    # within one bf16 rounding where the dtype is bf16
    bf = dict(rtol=2.0**-8, atol=1e-7)
    check_tree(ts.master, ref["master"])
    check_tree(ts.m, ref["m"], **(bf if moment_dtype == "bfloat16" else {}))
    check_tree(ts.v, ref["v"], **(bf if moment_dtype == "bfloat16" else {}))
    check_tree(tp, ref["params"], **(bf if param_dtype else {}))
    for tm, jm in metrics:
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 50.0])
def test_clipping_and_global_norm(grad_scale):
    """Below the clip norm the gradient passes as it is; above it is scaled
    to the clip norm; both as the reference."""
    g = mixed_tree(7)
    g = jax.tree.map(lambda a: (grad_scale * a).astype(np.float32), g)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(opt.global_norm(to_torch(unstack(g))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tp, ts, ref, _ = run_both("float32", None, steps=2,
                              grad_scale=grad_scale)
    check_tree(ts.master, ref["master"])
    check_tree(ts.m, ref["m"])
    check_tree(ts.v, ref["v"])


def test_weight_decay_by_reference_rank():
    """The reference decays a leaf of rank >= 2 in its own tree: every
    per-layer leaf of a stacked (homogeneous) stack, norm scales included,
    but not the 1-D top-level leaves nor those of a list-of-layers stack
    (the xLSTM's)."""
    p = to_torch(unstack(mixed_tree(0)))
    stacked = opt.decay_mask(p, stacked_layers=True)
    listed = opt.decay_mask(p, stacked_layers=False)
    assert stacked["w"] and stacked["experts"] and not stacked["norm"]
    assert all(d["wq"] and d["norm1"] for d in stacked["layers"])
    assert all(d["wq"] and not d["norm1"] for d in listed["layers"])
    # a zero gradient: only decay moves a weight, by lr * wd * p
    cfg = opt.OptConfig(**CFG)
    zeros = opt.tree_unflatten(p, [torch.zeros_like(t)
                                   for t in opt.tree_leaves(p)])
    new, _, m = opt.update(cfg, zeros, opt.init(p, cfg),
                          stacked_layers=True)
    lr = float(m["lr"])
    for d in (new["layers"][0]["norm1"], new["w"]):
        assert float(d.abs().max()) > 0
    moved = new["layers"][0]["norm1"] - p["layers"][0]["norm1"]
    torch.testing.assert_close(moved, -lr * 0.1 * p["layers"][0]["norm1"],
                               rtol=1e-3, atol=1e-9)  # p - lr*wd*p - p
    assert torch.equal(new["norm"], p["norm"])
    # a list-of-layers stack: the port's own ranks (the reference's rule
    # on an unstacked tree such as the xLSTM's)
    new2, _, _ = opt.update(cfg, zeros, opt.init(p, cfg),
                            stacked_layers=False)
    assert torch.equal(new2["layers"][0]["norm1"], p["layers"][0]["norm1"])


def test_state_specs_mirror_the_parameters():
    """The reference's rule: the step replicated, m, v and master the
    parameters' specs (the same objects)."""
    from repro_torch.models import common as cm

    specs = {"w": cm.P("data", "model"), "layers": [{"n": cm.P(None)}]}
    got = opt.state_specs(specs)
    assert tuple(got.step) == () and isinstance(got.step, cm.P)
    assert got.m is got.v is got.master is specs


def test_update_on_dtensors_equals_plain():
    """On a world-1 mesh the state's leaves are DTensors (m, v and master
    with the parameters' placements, the step replicated) and two steps
    of ``update`` give the plain tensors' results bit for bit, the global
    norm included."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common as cm
    from repro_torch.runtime import elastic

    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((4, 6), generator=g), "n": torch.randn((6,),
                                                                 generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p.items()}
             for _ in range(2)]
    specs = {"w": cm.P("data", "model"), "n": cm.P(None)}
    cfg = opt.OptConfig(lr=0.1, warmup_steps=1, total_steps=10,
                        moment_dtype="bfloat16")
    mesh = mesh_lib.make_host_mesh("cpu")
    try:
        dp = elastic.reshard(p, specs, mesh)
        st, dst = opt.init(p, cfg), opt.init(dp, cfg)
        assert isinstance(dst.step, DTensor)
        assert dst.step.placements == (Replicate(), Replicate())
        assert dst.m["w"].placements == (Shard(0), Shard(1))
        for gr in grads:
            new, st, m = opt.update(cfg, gr, st, stacked_layers=False)
            dnew, dst, dm = opt.update(cfg, elastic.reshard(gr, specs, mesh),
                                       dst, stacked_layers=False)
            assert float(dm["grad_norm"]) == float(m["grad_norm"])
            for k in p:
                assert torch.equal(dnew[k].full_tensor(), new[k])
                assert torch.equal(dst.v[k].full_tensor(), st.v[k])
        assert int(dst.step.full_tensor()) == 2
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# mirrors of the reference's TestOptimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    params = {"w": torch.ones((4, 4)) * 5.0}
    state = opt.init(params)
    cfg = opt.OptConfig(lr=0.5, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    for _ in range(60):
        g = {"w": 2 * params["w"]}  # d/dw sum(w^2)
        params, state, m = opt.update(cfg, g, state, stacked_layers=False)
    assert float(params["w"].abs().max()) < 1.0


def test_clip_and_schedule():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(opt.schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(opt.schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert float(opt.schedule(cfg, torch.tensor(100))) <= 0.11
