"""Port parity for the vlm family's forward (``models/vlm.py`` and the
``extra_embeds`` half of ``models/transformer.py``) on the SKILL smoke
config (``phi-3-vision-4.2b``: 2 layers, MHA, 16 patch embeddings, f32):

* logits with the patches prepended, and without them, on the reference's
  own weights (``convert.py``), tokens and patches;
* the dense-cache prefill of patches + S - 1 tokens, then one decode step
  at ``pos = S - 1 + n_img``, against the reference's same two calls;
* the reference's ``tests/models/test_smoke.py`` cases for vlm, run in the
  port.

Tolerance: allclose at rtol = atol = 1e-5 (f32 sums in another order;
measured max 4.5e-6 on logits of scale ~4). The reference's fixtures are
built once for the module, as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core import adapters
from repro_torch.models import model_zoo

ARCH = "phi-3-vision-4.2b"
B, S = 2, 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    cfg = JSMOKE[ARCH].scaled(dtype="float32")
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
               * 0.1).astype(np.float32)
    batch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    out = {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
           "patches": patches}
    out["logits"] = np.asarray(model.forward(params, batch, remat=False)[0])
    out["text_logits"] = np.asarray(model.forward(
        params, {"tokens": batch["tokens"]}, remat=False)[0])
    n_img = cfg.n_image_tokens
    cache = model.init_cache(B, S + n_img + 4, dtype=jnp.float32)
    prefill = {"tokens": batch["tokens"][:, :S - 1],
               "patches": batch["patches"]}
    lp, cache, _ = model.forward(params, prefill, cache=cache, pos=0,
                                 remat=False)
    ld, _, _ = model.forward(params, {"tokens": batch["tokens"][:, S - 1:]},
                             cache=cache, pos=S - 1 + n_img, remat=False)
    out["prefill"], out["decode"] = np.asarray(lp), np.asarray(ld)
    return out


@pytest.fixture(scope="module")
def port(ref):
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    return cfg, model, params_from_jax(ref["params"], cfg, device="cpu")


def _batch(ref, with_patches=True):
    batch = {"tokens": torch.from_numpy(ref["tokens"]).long()}
    if with_patches:
        batch["patches"] = torch.from_numpy(ref["patches"])
    return batch


def test_logits_with_patches_match_reference(ref, port):
    cfg, model, params = port
    logits = model.forward(params, _batch(ref))[0]
    assert logits.shape == (B, cfg.n_image_tokens + S, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)


def test_text_only_logits_match_reference(ref, port):
    _, model, params = port
    logits = model.forward(params, _batch(ref, with_patches=False))[0]
    np.testing.assert_allclose(logits.numpy(), ref["text_logits"], **TOL)


def test_prefill_then_decode_matches_reference(ref, port):
    cfg, model, params = port
    n_img = cfg.n_image_tokens
    batch = _batch(ref)
    cache = model.init_cache(B, S + n_img + 4, dtype=torch.float32,
                             device="cpu")
    lp, cache, _ = model.forward(
        params, {"tokens": batch["tokens"][:, :S - 1],
                 "patches": batch["patches"]}, cache=cache, pos=0)
    ld = model.forward(params, {"tokens": batch["tokens"][:, S - 1:]},
                       cache=cache, pos=S - 1 + n_img)[0]
    np.testing.assert_allclose(lp.numpy(), ref["prefill"], **TOL)
    np.testing.assert_allclose(ld.numpy(), ref["decode"], **TOL)


def test_calib_extras_and_registry(port):
    """vlm calibrates on text alone: no batch extras; the adapter is the
    transformer one."""
    cfg, model, params = port
    assert adapters.calib_extras(cfg, torch.zeros((1, 4))) == {}
    assert type(adapters.get_adapter(model, params)).__name__ == (
        "TransformerAdapter")


def _smoke_model():
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    return cfg, model, model.init_params(seed=0, device="cpu")


def _smoke_batch(cfg):
    g = torch.Generator().manual_seed(1)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            "patches": torch.randn((B, cfg.n_image_tokens, cfg.d_model),
                                   generator=g) * 0.1}


def test_forward_shapes_finite():
    """tests/models/test_smoke.py::test_forward_shapes_finite[phi-3-...]."""
    cfg, model, params = _smoke_model()
    logits, cache, aux = model.forward(params, _smoke_batch(cfg))
    assert logits.shape == (B, S + cfg.n_image_tokens, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert cache is None and torch.isfinite(aux)


def test_decode_matches_prefill():
    """tests/models/test_smoke.py::test_decode_matches_prefill[phi-3-...]
    (the reference's tolerance)."""
    cfg, model, params = _smoke_model()
    batch = _smoke_batch(cfg)
    n_img = cfg.n_image_tokens
    full = model.forward(params, batch)[0]
    cache = model.init_cache(B, S + n_img + 4, dtype=torch.float32,
                             device="cpu")
    _, cache, _ = model.forward(
        params, {"tokens": batch["tokens"][:, :S - 1],
                 "patches": batch["patches"]}, cache=cache, pos=0)
    step = model.forward(params, {"tokens": batch["tokens"][:, S - 1:]},
                         cache=cache, pos=S - 1 + n_img)[0]
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)
