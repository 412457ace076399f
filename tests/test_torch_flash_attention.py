"""Port parity for the long-sequence attention path: the port's
``flash_attention_plain`` (the kernel's plain version, what the CPU runs)
against the reference's Pallas kernel in interpret mode, on the grid of
``tests/kernels/test_kernels.py::TestFlashAttentionKernel``; the port's
``models/attention.flash_attention`` against the reference's XLA two-level
scan; the "flash" dispatch counter; the shapes both refuse; and ``pre_out``,
a dense-cache prefill and a 2-layer forward at S = 4096 on the f32 smoke
width against the reference's own.

The reference's ``TestFlashDispatch.test_traced_offset_falls_back_to_xla``
has no counterpart: a port ``q_offset`` is always a Python int (the port
runs eagerly), so there is no traced offset to fall back on.

Inputs come from numpy and go to both packages; reference results are built
once per module, as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.kernels.flash_attention import flash_attention_tpu
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, model_zoo
from repro_torch.obs import dispatch

# (B, S, H, KV, hd, block_q, block_k, causal): TestFlashAttentionKernel's
KERNEL_GRID = [
    (2, 256, 8, 4, 64, 64, 64, True),
    (2, 256, 8, 4, 64, 64, 64, False),
    (1, 128, 4, 4, 32, 32, 64, True),   # MHA, uneven blocks
    (2, 128, 8, 2, 64, 128, 32, True),  # G=4 GQA
]
# (Sq, Sk, q_offset): TestFlashAttentionKernel.test_q_offset_matches_xla_scan
OFFSET_GRID = [(64, 64, 32), (64, 192, 128), (1, 64, 63)]
# (B, Sq, Sk, H, KV, hd, causal, q_offset): through the XLA scan's chunking
SCAN_GRID = [
    (1, 4096, 4096, 4, 2, 16, True, 0),     # 8 q chunks x 4 kv chunks
    (1, 512, 2048, 4, 4, 32, False, 0),     # non-causal, Sk != Sq
    (1, 1024, 3072, 2, 1, 8, True, 2048),   # a chunk continuing a prefix
    (1, 8192, 8192, 2, 1, 8, True, 0),      # nk >= 8: the causal chunk skip
]
# (Sq, Sk): the reference's scan asserts Sq % min(512, Sq) == 0 and
# Sk % min(1024, Sk) == 0
REFUSAL_GRID = [(600, 600), (1024, 1536), (700, 900), (300, 900),
                (1536, 3072)]
TINY_S = 4096
SMOKE_KW = dict(dtype="float32", max_seq_len=TINY_S)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, B, Sq, Sk, H, KV, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(dtype),
            rng.standard_normal((B, Sk, KV, hd)).astype(dtype),
            rng.standard_normal((B, Sk, KV, hd)).astype(dtype))


def _torch(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _ref_kernel(q, k, v, jdtype=jnp.float32, **kw):
    out = flash_attention_tpu(*(jnp.asarray(a, jdtype) for a in (q, k, v)),
                              interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs on every case, as numpy."""
    out = {"grid": [], "offset": [], "scan": [], "dtypes": {}}
    for i, (B, S, H, KV, hd, bq, bk, causal) in enumerate(KERNEL_GRID):
        q, k, v = _qkv(i, B, S, S, H, KV, hd)
        out["grid"].append(_ref_kernel(q, k, v, causal=causal, block_q=bq,
                                       block_k=bk))
    for i, (Sq, Sk, off) in enumerate(OFFSET_GRID):
        q, k, v = _qkv(10 + i, 2, Sq, Sk, 4, 2, 32)
        out["offset"].append(_ref_kernel(q, k, v, causal=True, q_offset=off,
                                         block_q=min(64, Sq), block_k=32))
    for name, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        q, k, v = _qkv(20, 1, 128, 128, 4, 2, 32)
        out["dtypes"][name] = _ref_kernel(q, k, v, jdt, causal=True,
                                          block_q=64, block_k=64)
    for i, (B, Sq, Sk, H, KV, hd, causal, off) in enumerate(SCAN_GRID):
        q, k, v = _qkv(30 + i, B, Sq, Sk, H, KV, hd)
        out["scan"].append(np.asarray(jattn.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            q_offset=off)))
    refused = []
    for Sq, Sk in REFUSAL_GRID:
        q, k, v = _qkv(40, 1, Sq, Sk, 2, 1, 8)
        try:
            jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=False)
            refused.append(False)
        except AssertionError:
            refused.append(True)
    out["refused"] = refused
    return out


@pytest.mark.parametrize("case", range(len(KERNEL_GRID)))
def test_plain_matches_pallas_kernel(ref, case):
    B, S, H, KV, hd, _, _, causal = KERNEL_GRID[case]
    q, k, v = _torch(*_qkv(case, B, S, S, H, KV, hd))
    got = fa.flash_attention(q, k, v, causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    # the reference kernel test's own tolerance (f32, other summation order)
    np.testing.assert_allclose(got.numpy(), ref["grid"][case], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("case", range(len(OFFSET_GRID)))
def test_plain_q_offset_matches_pallas_kernel(ref, case):
    Sq, Sk, off = OFFSET_GRID[case]
    q, k, v = _torch(*_qkv(10 + case, 2, Sq, Sk, 4, 2, 32))
    got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
    np.testing.assert_allclose(got.numpy(), ref["offset"][case], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtypes_match_pallas_kernel(ref, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = _qkv(20, 1, 128, 128, 4, 2, 32)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = fa.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == tdt
    # both compute in f32 from the same bf16 inputs and round the output
    # once: at most one bf16 ulp apart (2^-8 relative below magnitude 1)
    tol = 2e-4 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), ref["dtypes"][dtype],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", range(len(SCAN_GRID)))
def test_attention_flash_matches_xla_scan(ref, case):
    B, Sq, Sk, H, KV, hd, causal, off = SCAN_GRID[case]
    q, k, v = _torch(*_qkv(30 + case, B, Sq, Sk, H, KV, hd))
    got = attention.flash_attention(q, k, v, causal=causal, q_offset=off)
    # the same chunked online softmax in f32; einsum sums in another order
    np.testing.assert_allclose(got.numpy(), ref["scan"][case], rtol=1e-5,
                               atol=1e-5)


def test_q_offset_dispatches_through_flash_counter():
    """Mirror of TestFlashDispatch.test_q_offset_no_longer_skips_pallas: a
    nonzero static q_offset with Sk == Sq takes the flash path, and the
    "flash" counter shows it."""
    q, k, v = _qkv(3, 1, 64, 64, 4, 4, 32)
    dispatch.reset_dispatch_counters()
    got = attention.flash_attention(*_torch(q, k, v), causal=True,
                                    q_offset=16)
    assert dispatch.snapshot_dispatch_counters()["flash"] == {"fused": 1}
    want = jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=True, q_offset=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    dispatch.reset_dispatch_counters()


@pytest.mark.parametrize("case", range(len(REFUSAL_GRID)))
def test_refuses_the_shapes_the_reference_refuses(ref, case):
    Sq, Sk = REFUSAL_GRID[case]
    q, k, v = _torch(*_qkv(40, 1, Sq, Sk, 2, 1, 8))
    if ref["refused"][case]:
        with pytest.raises(ValueError, match="reference's chunks"):
            fa.flash_attention(q, k, v, causal=False)
    else:
        assert fa.flash_attention(q, k, v, causal=False).shape == q.shape


def test_refuses_what_the_kernel_does_not_take():
    q, k, v = _torch(*_qkv(5, 1, 64, 64, 4, 2, 32))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*_torch(*_qkv(5, 1, 64, 64, 2, 1, 6)),
                           causal=True)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, causal=True, q_offset=-1)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q.half(), k, v, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k, v.transpose(1, 2).contiguous().transpose(
            1, 2), causal=True)
    with pytest.raises(ValueError, match="inconsistent"):
        fa.flash_attention(q, k[:, :32], v, causal=True)


@pytest.fixture(scope="module")
def long_ref():
    """The reference's smoke model at S = 4096: params, pre_out of layer 0,
    a dense-cache prefill of layer 0 at S = 3072 and the 2-layer logits."""
    cfg = JSMOKE["llama2-7b"].scaled(**SMOKE_KW)
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, size=(1, TINY_S)).astype(
        np.int32)
    x = (rng.standard_normal((1, TINY_S, cfg.d_model)) * 0.5).astype(
        np.float32)
    lp = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    pre = jattn.pre_out(lp, cfg, jnp.asarray(x))
    S2 = 3072
    cache = jattn.init_cache(cfg, 1, S2, dtype=jnp.float32)
    y, _ = jattn.apply(lp, cfg, jnp.asarray(x[:, :S2]), pos=0, cache=cache)
    logits = model.forward(params, {"tokens": jnp.asarray(tokens)},
                           remat=False)[0]
    return dict(params=jax.tree.map(np.asarray, params), tokens=tokens, x=x,
                pre=np.asarray(pre), prefill=np.asarray(y),
                logits=np.asarray(logits))


def _long_port(long_ref):
    cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
    return cfg, params_from_jax(long_ref["params"], cfg, device="cpu")


def test_pre_out_at_4096_matches_reference(long_ref):
    cfg, params = _long_port(long_ref)
    dispatch.reset_dispatch_counters()
    got = attention.pre_out(params["layers"][0]["attn"], cfg,
                            torch.from_numpy(long_ref["x"]))
    assert dispatch.snapshot_dispatch_counters()["flash"]["fused"] == 1
    # f32, the same chunked softmax; projections and RoPE sum in another
    # order: measured max |diff| 8.9e-8 on outputs up to 1.41
    np.testing.assert_allclose(got.numpy(), long_ref["pre"], rtol=1e-6,
                               atol=1e-6)


def test_dense_cache_prefill_over_2048_matches_reference(long_ref):
    cfg, params = _long_port(long_ref)
    S2 = 3072
    cache = attention.init_cache(cfg, 1, S2, dtype=torch.float32)
    dispatch.reset_dispatch_counters()
    y, out_cache = attention.apply(params["layers"][0]["attn"], cfg,
                                   torch.from_numpy(long_ref["x"][:, :S2]),
                                   pos=0, cache=cache)
    assert dispatch.snapshot_dispatch_counters()["flash"]["fused"] == 1
    assert out_cache is cache
    # measured max |diff| 1.2e-7 on outputs up to 1.18
    np.testing.assert_allclose(y.numpy(), long_ref["prefill"], rtol=1e-6,
                               atol=1e-6)


def test_two_layer_forward_at_4096_matches_reference(long_ref):
    cfg, params = _long_port(long_ref)
    model = model_zoo.build(cfg)
    dispatch.reset_dispatch_counters()
    logits = model.forward(params, {"tokens": torch.from_numpy(
        long_ref["tokens"]).long()})[0]
    assert dispatch.snapshot_dispatch_counters()["flash"]["fused"] == 2
    # f32 forward of 2 layers at 4096 tokens; matmuls and the chunked
    # softmax sum in another order (measured max |diff| 3.2e-5 on logits
    # up to 4.95)
    np.testing.assert_allclose(logits.numpy(), long_ref["logits"],
                               rtol=1e-4, atol=1e-4)
