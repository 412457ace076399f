"""Port parity for paged decode attention: ``paged_attention_plain`` (the
plain version of the CUDA kernel, which CPU tensors take through the
``paged_attention`` wrapper) against the reference oracle
``ref.paged_attention_ref`` and, for a few cases, the Pallas kernel in
interpret mode, on the same numpy pools carried over with
``paged_cache_from_jax``. Sweeps page formats {16, 8, 4, vq2}, ragged
positions and GQA, and the masking invariants of
``tests/kernels/test_paged_attention.py``: the scratch block never leaks,
an idle slot at pos 0 is finite, stale rows of a recycled block and
poisoned codebook entries of masked rows are inert. Also the serving path:
the port's ``_paged_apply`` (gather and fused) against the reference's.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.kernels import kv_quant as jkvq
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_tpu
from repro.models import attention as jattn

from repro_torch.configs import SMOKE
from repro_torch.convert import paged_cache_from_jax
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_attention_plain)
from repro_torch.models import attention

BITS = [16, 8, 4, "vq2"]
# f32 sums in another order (torch vs XLA einsum and softmax)
TOL = 2e-5


def make_case(seed, *, B, H, KV, hd, page_size, n_pages, num_blocks,
              pos=None, bits=16):
    """Numpy pools quantized by the REFERENCE kv_quant, a page table mapping
    each slot's live pages to distinct blocks (scratch past them), ragged
    positions. Returns a dict of numpy arrays (None where a format has no
    scales or codebooks)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(num_blocks, page_size, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(num_blocks, page_size, KV, hd)).astype(np.float32)
    ksc = vsc = kcb = vcb = None
    if bits == "vq2":
        kcb = rng.normal(size=(KV, 16, 2)).astype(np.float32)
        vcb = rng.normal(size=(KV, 16, 2)).astype(np.float32)
        kp, ksc = map(np.asarray, jkvq.vq_quantize_rows(jnp.asarray(kp),
                                                        jnp.asarray(kcb)))
        vp, vsc = map(np.asarray, jkvq.vq_quantize_rows(jnp.asarray(vp),
                                                        jnp.asarray(vcb)))
    elif bits < 16:
        kp, ksc = map(np.asarray, jkvq.quantize_kv(jnp.asarray(kp), bits))
        vp, vsc = map(np.asarray, jkvq.quantize_kv(jnp.asarray(vp), bits))
    if pos is None:
        pos = rng.integers(0, n_pages * page_size, size=B)
    pos = np.asarray(pos, np.int32)
    table = np.zeros((B, n_pages), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for b in range(B):
        for p in range(min(int(pos[b]) // page_size + 1, n_pages)):
            table[b, p] = free.pop() if free else 0
    return dict(q=q, k=kp, v=vp, page_table=table, pos=pos, k_scale=ksc,
                v_scale=vsc, k_codebook=kcb, v_codebook=vcb)


def ref_out(c, kernel=False):
    """The reference's output on case ``c`` (oracle, or the Pallas kernel
    in interpret mode), as numpy."""
    j = {k: None if v is None else jnp.asarray(v) for k, v in c.items()}
    kw = dict(k_scale=j["k_scale"], v_scale=j["v_scale"],
              k_codebook=j["k_codebook"], v_codebook=j["v_codebook"])
    if kernel:
        out = paged_attention_tpu(j["q"], j["k"], j["v"], j["page_table"],
                                  j["pos"], interpret=True, **kw)
    else:
        out = jref.paged_attention_ref(j["q"], j["k"], j["v"],
                                       j["page_table"], j["pos"], **kw)
    return np.asarray(out, np.float32)


def port_out(c):
    """The port's wrapper (plain version on CPU tensors); the pools and
    table arrive through paged_cache_from_jax, as a reference cache."""
    (cache,) = paged_cache_from_jax(types.SimpleNamespace(**c), device="cpu")
    out = paged_attention(
        torch.from_numpy(c["q"]), cache.k, cache.v, cache.page_table,
        torch.from_numpy(c["pos"]), k_scale=cache.k_scale,
        v_scale=cache.v_scale, k_codebook=cache.k_codebook,
        v_codebook=cache.v_codebook)
    return out.numpy()


SHAPES = [
    (1, 4, 4, 32, 8, 4, 8),     # MHA, B=1
    (2, 8, 4, 32, 16, 4, 12),   # G=2
    (3, 8, 2, 64, 8, 6, 32),    # G=4, deep tables
    (4, 8, 1, 16, 4, 8, 40),    # MQA, tiny pages
    (5, 4, 2, 32, 1, 16, 90),   # page_size 1
]


@pytest.fixture(scope="module")
def sweep():
    """(case, oracle output) for every shape x format, computed once."""
    out = {}
    for bits in BITS:
        for shape in SHAPES:
            B, H, KV, hd, ps, n, nb = shape
            c = make_case(0, B=B, H=H, KV=KV, hd=hd, page_size=ps,
                          n_pages=n, num_blocks=nb, bits=bits)
            out[bits, shape] = (c, ref_out(c))
        for seed in range(2):
            c = make_case(seed, B=4, H=8, KV=4, hd=32, page_size=8,
                          n_pages=4, num_blocks=20, pos=[0, 1, 31, 16],
                          bits=bits)
            out[bits, "ragged", seed] = (c, ref_out(c))
    return out


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_oracle(sweep, bits, shape):
    c, want = sweep[bits, shape]
    np.testing.assert_allclose(port_out(c), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("seed", range(2))
def test_ragged_positions(sweep, bits, seed):
    c, want = sweep[bits, "ragged", seed]
    np.testing.assert_allclose(port_out(c), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_pallas_interpret(bits):
    c = make_case(3, B=2, H=8, KV=2, hd=32, page_size=8, n_pages=3,
                  num_blocks=10, pos=[20, 5], bits=bits)
    np.testing.assert_allclose(port_out(c), ref_out(c, kernel=True),
                               rtol=TOL, atol=TOL)


def test_quantized_plain_bitwise_vs_decoded_pool():
    """One decode expression: the int8 plain version equals the plain
    version over the kv_quant-decoded f32 pool bit for bit."""
    from repro_torch.kernels import kv_quant as kvq

    c = make_case(7, B=3, H=8, KV=4, hd=32, page_size=8, n_pages=4,
                  num_blocks=16, bits=8)
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in c.items()}
    quant = paged_attention_plain(t["q"], t["k"], t["v"], t["page_table"],
                                  t["pos"], t["k_scale"], t["v_scale"])
    kd = kvq.dequant_rows(t["k"], t["k_scale"], 8)
    vd = kvq.dequant_rows(t["v"], t["v_scale"], 8)
    fp = paged_attention_plain(t["q"], kd, vd, t["page_table"], t["pos"])
    assert torch.equal(quant, fp)


def _poisoned(c, bits, *, blocks=None, tail=None):
    """Copy of case ``c`` with masked rows poisoned: whole ``blocks`` and
    the rows ``tail = (block, first_row)`` onward, codes and scales."""
    c = {k: None if v is None else np.array(v) for k, v in c.items()}
    kmag, vmag = (1e4, -1e4) if bits == 16 else (127, -127)
    if bits == "vq2":
        kmag = vmag = -1  # 0xFF: both nibbles index entry 15
    sl = [(b, slice(None)) for b in (blocks or [])]
    if tail is not None:
        sl.append((tail[0], slice(tail[1], None)))
    for b, rows in sl:
        c["k"][b, rows] = kmag
        c["v"][b, rows] = vmag
        if bits != 16:
            c["k_scale"][b, rows] = 9e3
            c["v_scale"][b, rows] = 9e3
    return c


@pytest.mark.parametrize("bits", BITS)
def test_scratch_block_never_leaks(bits):
    c = make_case(2, B=3, H=8, KV=4, hd=32, page_size=8, n_pages=4,
                  num_blocks=16, pos=[5, 17, 30], bits=bits)
    assert c["page_table"][:, 0].min() > 0
    base = port_out(c)
    poisoned = _poisoned(c, bits, blocks=[0])
    np.testing.assert_allclose(port_out(poisoned), base, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(port_out(poisoned), ref_out(poisoned),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", BITS)
def test_idle_slot_pos0_is_finite(bits):
    c = make_case(3, B=2, H=4, KV=2, hd=16, page_size=8, n_pages=2,
                  num_blocks=6, pos=[9, 0], bits=bits)
    c["page_table"][1] = 0
    got = port_out(c)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_out(c), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", BITS)
def test_recycled_block_staleness(bits):
    """Rows past pos of the slot's last live page, and a mapped page past
    its depth, hold stale codes and scales: poisoning them moves nothing."""
    ps = 8
    c = make_case(4, B=1, H=8, KV=4, hd=32, page_size=ps, n_pages=3,
                  num_blocks=8, pos=[11], bits=bits)
    far = next(b for b in range(1, 8) if b not in c["page_table"][0])
    c["page_table"][0, 2] = far  # a block mapped past the slot's depth
    last_blk = int(c["page_table"][0, 1])
    base = port_out(c)
    poisoned = _poisoned(c, bits, blocks=[far],
                         tail=(last_blk, 11 % ps + 1))
    np.testing.assert_allclose(port_out(poisoned), base, rtol=1e-6,
                               atol=1e-6)


def test_codebook_poison_masked_rows_inert():
    c = make_case(8, B=2, H=4, KV=2, hd=16, page_size=4, n_pages=4,
                  num_blocks=10, pos=[5, 9], bits="vq2")
    c["k_codebook"][:, 15] = 1e4
    c["v_codebook"][:, 15] = -1e4
    base = port_out(c)
    poisoned = _poisoned(c, "vq2", blocks=[0])
    np.testing.assert_allclose(port_out(poisoned), base, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bits", BITS)
def test_paged_apply_matches_reference(bits):
    """The serving path: the port's _paged_apply (write through the page
    table, then gather or fused read) against the reference's gather path,
    with wo = I, the same pools and fresh K/V rows. The port writes in
    place; the written pools must equal the reference's bitwise."""
    cfg_kw = dict(dtype="float32", n_layers=1, d_model=128, vocab_size=64,
                  max_seq_len=32)
    jcfg = JSMOKE["llama2-7b"].scaled(**cfg_kw)
    cfg = SMOKE["llama2-7b"].scaled(**cfg_kw)
    B, H, KV, hd = 2, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    c = make_case(5, B=B, H=H, KV=KV, hd=hd, page_size=4, n_pages=8,
                  num_blocks=12, pos=[6, 21], bits=bits)
    rng = np.random.default_rng(9)
    knew = rng.normal(size=(B, 1, KV, hd)).astype(np.float32)
    vnew = rng.normal(size=(B, 1, KV, hd)).astype(np.float32)
    j = {k: None if v is None else jnp.asarray(v) for k, v in c.items()}
    jcache = jattn.PagedKVCache(j["k"], j["v"], j["page_table"],
                                j["k_scale"], j["v_scale"], j["k_codebook"],
                                j["v_codebook"])
    want, jnew = jattn._paged_apply(
        {"wo": jnp.eye(H * hd)}, jcache, j["q"][:, None], jnp.asarray(knew),
        jnp.asarray(vnew), j["pos"][:, None], jnp.float32, impl="gather")
    for impl in ("gather", "fused"):
        (cache,) = paged_cache_from_jax(types.SimpleNamespace(**c),
                                        device="cpu")
        got, new = attention._paged_apply(
            {"wo": torch.eye(H * hd)}, cache,
            torch.from_numpy(c["q"])[:, None], torch.from_numpy(knew),
            torch.from_numpy(vnew), torch.from_numpy(c["pos"]).long()[:, None],
            torch.float32, impl=impl)
        assert new.k is cache.k  # written in place, not copied
        np.testing.assert_array_equal(new.k.numpy(), np.asarray(jnew.k))
        np.testing.assert_array_equal(new.v.numpy(), np.asarray(jnew.v))
        if bits != 16:
            np.testing.assert_array_equal(new.k_scale.numpy(),
                                          np.asarray(jnew.k_scale))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    assert jcfg.hd == cfg.hd


def test_ports_dispatch_counts_fused_and_gather():
    from repro_torch.obs import dispatch

    counts = dispatch.snapshot_dispatch_counters()["paged"]
    assert set(counts) == {"gather", "fused"}
    with pytest.raises(ValueError, match="fused"):
        attention.check_paged_impl("pallas")
