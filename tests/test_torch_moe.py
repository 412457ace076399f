"""Port parity for the MoE family's model on the SKILL smoke config
(``qwen3-moe-30b-a3b``: 8 experts, top-2, f32): ``moe.apply`` without
drops and with capacity drops (outputs, aux loss and the kept mask),
``expert_hessians`` (full and ``diag_only``) against the reference and a
naive token loop, ``common.expert_matmul`` on dense and stacked fused
leaves with its "matmul" dispatch counts, and the whole model's
teacher-forced logits with the router kept f32.

The reference's fixtures are built once for the module, as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core import pipeline
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import VQConfig
from repro_torch.models import common as cm
from repro_torch.models import model_zoo, moe
from repro_torch.obs import dispatch

ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ref_kept(expert_ids: np.ndarray, E: int, C: int) -> np.ndarray:
    """The reference's kept mask from its expert ids (B, S, K): its
    per-row exclusive cumsum of one-hot slots, in numpy."""
    B, S, K = expert_ids.shape
    oh = np.eye(E, dtype=np.int64)[expert_ids].reshape(B, S * K, E)
    slot = ((np.cumsum(oh, axis=1) - oh) * oh).sum(-1).reshape(B, S, K)
    return slot < C


def _ref_ids(p, x, K):
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ p["router"], -1)
    top, ids = jax.lax.top_k(probs, K + 1)
    return np.asarray(ids[..., :K]), np.asarray(top)


@pytest.fixture(scope="module")
def ref():
    """Reference layer params, inputs and outputs, as numpy."""
    out = {}
    for cf, (B, S) in ((8.0, (2, 6)), (1.25, (2, 96))):
        cfg = JSMOKE[ARCH].scaled(dtype="float32", moe_capacity_factor=cf)
        p = jmoe.init(jax.random.PRNGKey(3), cfg, jnp.float32)
        x = np.random.default_rng(5).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        y, aux = jmoe.apply(p, cfg, jnp.asarray(x))
        ids, top = _ref_ids(p, x, cfg.n_experts_active)
        out[cf] = dict(p=_np(p), x=x, y=np.asarray(y), aux=float(aux),
                       ids=ids, top=top,
                       kept=_ref_kept(ids, cfg.n_experts,
                                      jmoe.capacity(S, cfg)))
    cfg = JSMOKE[ARCH].scaled(dtype="float32")
    p = out[8.0]["p"]
    x = out[8.0]["x"]
    out["hessians"] = {
        diag: _np(jmoe.expert_hessians(p, cfg, jnp.asarray(x),
                                       diag_only=diag))
        for diag in (False, True)}
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    out["model"] = dict(params=_np(params), tokens=tokens, logits=np.asarray(
        model.forward(params, {"tokens": jnp.asarray(tokens)},
                      remat=False)[0]),
        n_params=sum(a.size for a in jax.tree.leaves(params)))
    return out


def _port_layer(r, cf):
    cfg = SMOKE[ARCH].scaled(dtype="float32", moe_capacity_factor=cf)
    return cfg, {k: _t(v) for k, v in r["p"].items()}


def _replay(monkeypatch, ids):
    """Route with the reference's expert ids (gates from the port's own
    probabilities at those ids): near-ties between the K-th and (K+1)-th
    probability may order differently across frameworks."""
    ids_t = torch.from_numpy(ids).long()
    real = moe.route

    def route(x, router, k):
        probs, _, _ = real(x, router, k)
        return probs, probs.gather(-1, ids_t), ids_t

    monkeypatch.setattr(moe, "route", route)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_apply_matches_reference(ref, cf, monkeypatch):
    """Dropless (capacity factor 8, as the reference's decode test) and
    with the config's 1.25 on a batch long enough to drop tokens: the same
    outputs, aux loss and kept mask."""
    r = ref[cf]
    K = r["ids"].shape[-1]
    if (np.abs(r["top"][..., K - 1] - r["top"][..., K]) < 1e-6).any():
        _replay(monkeypatch, r["ids"])
    cfg, p = _port_layer(r, cf)
    x = torch.from_numpy(r["x"])
    _, _, ids = moe.route(x, p["router"], K)
    np.testing.assert_array_equal(ids.numpy(), r["ids"])
    _, keep = moe.dispatch(ids, cfg.n_experts, moe.capacity(x.shape[1], cfg))
    np.testing.assert_array_equal(keep.numpy(), r["kept"])
    if cf == 1.25:
        assert not r["kept"].all()  # tokens are dropped
    else:
        assert r["kept"].all()
    y, aux = moe.apply(p, cfg, x)
    # f32 routing, matmuls and the gate-weighted sum in another order
    np.testing.assert_allclose(y.numpy(), r["y"], rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - r["aux"]) <= 1e-6


def test_router_stays_f32():
    cfg = SMOKE[ARCH].scaled(dtype="bfloat16")
    p = model_zoo.build(cfg).init_params(seed=0, device="cpu")
    ffn = p["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert {ffn[w].dtype for w in ("w_in", "w_gate", "w_out")} == {
        torch.bfloat16}
    assert ffn["w_in"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert ffn["w_out"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    x = torch.randn((1, 5, cfg.d_model)).to(torch.bfloat16)
    y, aux = moe.apply(ffn, cfg, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


@pytest.mark.parametrize("diag_only", [False, True])
def test_expert_hessians_match_reference(ref, diag_only):
    cfg, p = _port_layer(ref[8.0], 8.0)
    (Hin, n_in), (Hout, n_out) = moe.expert_hessians(
        p, cfg, torch.from_numpy(ref[8.0]["x"]), diag_only=diag_only)
    (jHin, jn_in), (jHout, jn_out) = ref["hessians"][diag_only]
    np.testing.assert_array_equal(n_in.numpy(), jn_in)
    np.testing.assert_array_equal(n_out.numpy(), jn_out)
    for got, want in ((Hin, jHin), (Hout, jHout)):
        assert got.shape == want.shape
        # f32 sums of a dozen products in another order; entries that
        # cancel to near zero are held to the stack's scale
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_expert_hessians_match_naive_token_loop(ref):
    """The routed-token accumulation on the input side and the routed-token
    masking on the w_out side (tests/core/test_adapters.py's loop)."""
    cfg, p = _port_layer(ref[8.0], 8.0)
    x = ref[8.0]["x"]
    (Hin, n_in), (Hout, _) = moe.expert_hessians(p, cfg, torch.from_numpy(x))
    E, K = cfg.n_experts, cfg.n_experts_active
    xf = x.astype(np.float64).reshape(-1, cfg.d_model)
    router, w_in, w_gate = (ref[8.0]["p"][k].astype(np.float64)
                            for k in ("router", "w_in", "w_gate"))
    F = w_in.shape[-1]
    Hin_ref = np.zeros((E, cfg.d_model, cfg.d_model))
    Hout_ref = np.zeros((E, F, F))
    n_ref = np.zeros(E)
    for t in range(xf.shape[0]):
        logits = xf[t] @ router
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        for e in np.argsort(-probs, kind="stable")[:K]:
            n_ref[e] += 1
            Hin_ref[e] += np.outer(xf[t], xf[t])
            g = xf[t] @ w_gate[e]
            h = (g / (1 + np.exp(-g))) * (xf[t] @ w_in[e])
            Hout_ref[e] += np.outer(h, h)
    np.testing.assert_array_equal(n_in.numpy(), n_ref)
    np.testing.assert_allclose(Hin.numpy(), Hin_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Hout.numpy(), Hout_ref, rtol=1e-4, atol=1e-4)


def test_expert_matmul_dense_and_dispatch_counts():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 16, 8), generator=g)
    x3 = torch.randn((3, 5, 16), generator=g)
    x4 = torch.randn((2, 3, 5, 16), generator=g)
    before = dispatch.snapshot_dispatch_counters()["matmul"]
    y3, y4 = cm.expert_matmul(x3, w), cm.expert_matmul(x4, w)
    after = dispatch.snapshot_dispatch_counters()["matmul"]
    want = np.einsum("ecd,edf->ecf", x3.numpy(), w.numpy())
    np.testing.assert_allclose(y3.numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.einsum("becd,edf->becf", x4.numpy(), w.numpy())
    np.testing.assert_allclose(y4.numpy(), want, rtol=1e-5, atol=1e-5)
    assert after["expert_dense"] - before["expert_dense"] == 2
    cm.matmul(x3[0], w[0])
    assert (dispatch.snapshot_dispatch_counters()["matmul"]["dense"]
            == after["dense"] + 1)


def _quantized(seed, r=64, c=256):
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((r, c), generator=g)
    X = torch.randn((4 * c, c), generator=g)
    cfg = VQConfig(d=2, bits_per_dim=2, group_size=2048, em_iters=8,
                   codebook_update_iters=0)
    return vql.quantize_array(W, X.T @ X, cfg, generator=g)


def test_stacked_expert_leaves():
    """Stacked leaves (a leading E on every array, as the pipeline packs an
    expert stack) through ``expert_matmul``: the per-expert dense einsum
    (TestFusedVQLinear::test_stacked_expert_leaves), in both of its x
    forms; dequantize maps over the stack; fused_matmul refuses it."""
    v1, v2 = _quantized(1), _quantized(2)
    stacked = pipeline._stack_packed([v1, v2])
    assert stacked.words.shape[0] == 2 and stacked.r == 64
    fvl = vql.prepare_fused(stacked)
    assert fvl.prepared.n_experts == 2
    W = torch.stack([vql.dequantize(v, torch.float32).T for v in (v1, v2)])
    torch.testing.assert_close(
        vql.dequantize(stacked, torch.float32).transpose(-1, -2), W,
        rtol=0, atol=0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 256), generator=g)
    before = dispatch.snapshot_dispatch_counters()
    y = cm.expert_matmul(x, fvl)
    y_ref = torch.einsum("ecd,edf->ecf", x, W)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    x4 = torch.randn((3, 2, 4, 256), generator=g)
    y4 = cm.expert_matmul(x4, fvl)
    np.testing.assert_allclose(
        y4.numpy(), torch.einsum("becd,edf->becf", x4, W).numpy(),
        rtol=2e-4, atol=2e-4)
    after = dispatch.snapshot_dispatch_counters()
    assert (after["matmul"]["expert_fused_vq"]
            - before["matmul"]["expert_fused_vq"]) == 2
    assert after["vq"]["fused"] - before["vq"]["fused"] == 2
    with pytest.raises(ValueError, match="expert_matmul"):
        vql.fused_matmul(x[0], fvl)
    dense = vql.dequant_tree({"w": stacked}, torch.float32)["w"]
    assert dense.shape == (2, 256, 64)


def test_model_logits_match_reference(ref):
    """The whole smoke model (2 MoE layers) after params_from_jax:
    teacher-forced logits, parameter count, the router kept f32."""
    r = ref["model"]
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    assert model_zoo.count_params(model) == r["n_params"]
    params = params_from_jax(r["params"], cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    assert params["layers"][0]["ffn"]["w_in"].shape == (
        cfg.n_experts, cfg.d_model, cfg.d_ff)
    logits, _, aux = model.forward(params, {"tokens": torch.from_numpy(
        r["tokens"]).long()})
    assert torch.isfinite(aux)
    # f32 forward of 2 layers; matmul and softmax sums in another order
    np.testing.assert_allclose(logits.numpy(), r["logits"], rtol=1e-4,
                               atol=1e-4)
    bf16 = params_from_jax(r["params"], cfg.scaled(dtype="bfloat16"),
                           device="cpu")
    assert bf16["layers"][1]["ffn"]["router"].dtype == torch.float32
    assert bf16["layers"][1]["ffn"]["w_out"].dtype == torch.bfloat16
