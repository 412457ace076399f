"""Port parity for the ssm family's forward (``models/xlstm.py`` and the
xLSTM half of ``models/transformer.py``) on the SKILL smoke config
(``xlstm-125m``: 4 layers, sLSTM at layer 1, f32):

* ``mlstm_apply`` and ``slstm_apply`` on the reference's own block weights
  and inputs, without a cache and with a carried one (the second half of
  the sequence from the state the first half left), outputs and states;
* the whole model's logits on the reference's weights (``convert.py``);
* the reference's ``tests/models/test_smoke.py`` cases for ssm, run in the
  port: shapes and finiteness, and decode after prefill against the full
  forward.

Tolerance: allclose at rtol = atol = 2e-5. Both packages run the same f32
recurrence; ``exp``, ``log_sigmoid`` and the per-step contractions differ
by an ulp or so between XLA and PyTorch, and those differences carry
through at most 32 steps (measured max 1.4e-6 on logits of scale ~0.7).
The reference's fixtures are built once for the module, as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.models import model_zoo, transformer, xlstm

ARCH = "xlstm-125m"
B, S = 2, 16
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # the recurrences run ~15-30 tiny ops a step: one thread a worker
    # beats a pool that the suite's other workers also want
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    cfg = JSMOKE[ARCH].scaled(dtype="float32")
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    x = (rng.standard_normal((B, 2 * S, cfg.d_model)) * 0.5).astype(
        np.float32)
    out = {"params": _np(params), "tokens": tokens, "x": x}
    out["logits"] = np.asarray(model.forward(
        params, {"tokens": jnp.asarray(tokens)}, remat=False)[0])
    xs = jnp.asarray(x)
    for kind, i in (("mlstm", 0), ("slstm", 1)):
        assert jtransformer.block_kind(cfg, i) == kind
        core = params["layers"][i]["core"]
        apply = jxlstm.mlstm_apply if kind == "mlstm" else jxlstm.slstm_apply
        init = jxlstm.mlstm_cache if kind == "mlstm" else jxlstm.slstm_cache
        out[f"{kind} none"] = np.asarray(apply(core, cfg, xs, None)[0])
        y1, c1 = apply(core, cfg, xs[:, :S], init(cfg, B))
        y2, c2 = apply(core, cfg, xs[:, S:], c1)
        out[f"{kind} cache"] = (np.asarray(y1), np.asarray(y2), _np(c2))
    return out


@pytest.fixture(scope="module")
def port(ref):
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    return cfg, model, params_from_jax(ref["params"], cfg, device="cpu")


@pytest.mark.parametrize("kind,index", [("mlstm", 0), ("slstm", 1)])
def test_block_apply_matches_reference(ref, port, kind, index):
    cfg, _, params = port
    assert transformer.block_kind(cfg, index) == kind
    core = params["layers"][index]["core"]
    apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
    x = torch.from_numpy(ref["x"])
    y, state = apply(core, cfg, x, None)
    assert state is None
    np.testing.assert_allclose(y.numpy(), ref[f"{kind} none"], **TOL)


@pytest.mark.parametrize("kind,index", [("mlstm", 0), ("slstm", 1)])
def test_block_apply_with_carried_cache_matches_reference(ref, port, kind,
                                                          index):
    cfg, _, params = port
    core = params["layers"][index]["core"]
    apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
    init = xlstm.mlstm_cache if kind == "mlstm" else xlstm.slstm_cache
    x = torch.from_numpy(ref["x"])
    y1, c1 = apply(core, cfg, x[:, :S], init(cfg, B))
    y2, c2 = apply(core, cfg, x[:, S:], c1)
    r1, r2, rc = ref[f"{kind} cache"]
    np.testing.assert_allclose(y1.numpy(), r1, **TOL)
    np.testing.assert_allclose(y2.numpy(), r2, **TOL)
    assert type(c2)._fields == tuple(rc._fields)
    for got, want in zip(c2, rc):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_model_logits_match_reference(ref, port):
    cfg, model, params = port
    logits = model.forward(params, {"tokens": torch.from_numpy(
        ref["tokens"]).long()})[0]
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)


def test_block_kinds_and_tied_unembed(port):
    cfg, _, params = port
    kinds = [transformer.block_kind(cfg, i) for i in range(cfg.n_layers)]
    assert kinds == ["slstm" if i in cfg.slstm_layers else "mlstm"
                     for i in range(cfg.n_layers)]
    assert "lm_head" not in params  # tied: unembed through embed.T
    core = params["layers"][1]["core"]
    assert core["r_z"].shape == (cfg.n_heads, cfg.d_model // cfg.n_heads,
                                 cfg.d_model // cfg.n_heads)
    assert core["ffn"]["w_in"].shape == (cfg.d_model,
                                         xlstm.slstm_ffn_dim(cfg))
    assert xlstm.slstm_ffn_dim(cfg.scaled(d_model=768)) == 1024


def _smoke_model():
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    return cfg, model, model.init_params(seed=0, device="cpu")


def test_forward_shapes_finite():
    """tests/models/test_smoke.py::test_forward_shapes_finite[xlstm-125m]."""
    cfg, model, params = _smoke_model()
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    logits, cache, aux = model.forward(params, {"tokens": tokens})
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert cache is None and torch.isfinite(aux)


def test_decode_matches_prefill():
    """tests/models/test_smoke.py::test_decode_matches_prefill[xlstm-125m]:
    S - 1 tokens into the recurrent state, then one step, against the full
    forward's last row (the reference's tolerance)."""
    cfg, model, params = _smoke_model()
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    full = model.forward(params, {"tokens": tokens})[0]
    cache = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
    assert all(isinstance(c, (xlstm.MLSTMCache, xlstm.SLSTMCache))
               for c in cache)
    _, cache, _ = model.forward(params, {"tokens": tokens[:, :S - 1]},
                                cache=cache, pos=0)
    step = model.forward(params, {"tokens": tokens[:, S - 1:]}, cache=cache,
                         pos=S - 1)[0]
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)
