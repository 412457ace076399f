"""Port parity for ``kernels/kv_quant.py``: every op of the page formats is
bitwise equal to the reference's on the same numpy inputs (codes, scales,
int4 and vq2 packing, the decodes, the default codebook, byte accounting),
plus the edge cases of ``tests/kernels/test_kv_quant.py`` inside the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as jkvq

from repro_torch.kernels import kv_quant as kvq


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def ref():
    """Reference outputs as numpy, computed once for the module."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 3, 32)).astype(np.float32)
    x[0, 0, 1] = 0.0                                   # a zero row
    x[1, 2, 0, :4] = [0.5, -0.5, 1.5, -2.5]           # exact .5 ties
    cb = rng.normal(size=(3, 16, 2)).astype(np.float32)
    cb[:, 5] = cb[:, 2]                                # duplicate entries
    out = {"x": x, "cb": cb}
    for bits in (8, 4):
        c, s = jkvq.quantize_kv(jnp.asarray(x), bits)
        out[f"codes{bits}"], out[f"scales{bits}"] = _np(c), _np(s)
        out[f"dec{bits}"] = _np(jkvq.dequant_rows(c, s, bits))
    c, s = jkvq.vq_quantize_rows(jnp.asarray(x), jnp.asarray(cb))
    out["vq_codes"], out["vq_scales"] = _np(c), _np(s)
    out["vq_dec"] = _np(jkvq.vq_dequant_rows(c, s, jnp.asarray(cb)))
    out["vq_idx"] = _np(jkvq.unpack_vq2(c))
    out["default_cb"] = _np(jkvq.default_codebook(3))
    raw = rng.integers(-128, 128, size=(4, 7, 16)).astype(np.int8)
    out["raw"] = raw
    out["unpack4"] = _np(jkvq.unpack_int4(jnp.asarray(raw)))
    out["unpack_vq2"] = _np(jkvq.unpack_vq2(jnp.asarray(raw)))
    idx = rng.integers(0, 16, size=(4, 7, 16)).astype(np.int32)
    out["idx"] = idx
    out["pack_vq2"] = _np(jkvq.pack_vq2(jnp.asarray(idx)))
    codes = rng.integers(-7, 8, size=(4, 7, 16)).astype(np.int8)
    out["codes"] = codes
    out["pack4"] = _np(jkvq.pack_int4(jnp.asarray(codes)))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_bitwise(ref, bits):
    codes, scales = kvq.quantize_kv(_t(ref["x"]), bits)
    np.testing.assert_array_equal(codes.numpy(), ref[f"codes{bits}"])
    np.testing.assert_array_equal(scales.numpy(), ref[f"scales{bits}"])
    dec = kvq.dequant_rows(_t(ref[f"codes{bits}"]),
                           _t(ref[f"scales{bits}"]), bits)
    np.testing.assert_array_equal(dec.numpy(), ref[f"dec{bits}"])


def test_int4_and_vq2_packing_bitwise(ref):
    np.testing.assert_array_equal(kvq.pack_int4(_t(ref["codes"])).numpy(),
                                  ref["pack4"])
    np.testing.assert_array_equal(kvq.unpack_int4(_t(ref["raw"])).numpy(),
                                  ref["unpack4"])
    np.testing.assert_array_equal(kvq.pack_vq2(_t(ref["idx"])).numpy(),
                                  ref["pack_vq2"])
    np.testing.assert_array_equal(kvq.unpack_vq2(_t(ref["raw"])).numpy(),
                                  ref["unpack_vq2"])


def test_vq2_rows_bitwise(ref):
    codes, scales = kvq.vq_quantize_rows(_t(ref["x"]), _t(ref["cb"]))
    np.testing.assert_array_equal(codes.numpy(), ref["vq_codes"])
    np.testing.assert_array_equal(scales.numpy(), ref["vq_scales"])
    # entries 2 and 5 are equal: a tie must take 2, never 5
    assert not (kvq.unpack_vq2(codes) == 5).any()
    dec = kvq.vq_dequant_rows(_t(ref["vq_codes"]), _t(ref["vq_scales"]),
                              _t(ref["cb"]))
    np.testing.assert_array_equal(dec.numpy(), ref["vq_dec"])


def test_default_codebook_bitwise(ref):
    np.testing.assert_array_equal(kvq.default_codebook(3).numpy(),
                                  ref["default_cb"])


@pytest.mark.parametrize("bits", [16, 8, 4, "vq2"])
def test_byte_accounting_matches_reference(bits):
    for hd, kv, ps, db in ((32, 2, 8, 4), (128, 32, 16, 2), (64, 8, 1, 4)):
        assert kvq.row_bytes(hd, bits, dtype_bytes=db) == jkvq.row_bytes(
            hd, bits, dtype_bytes=db)
        assert kvq.page_bytes(ps, kv, hd, bits, dtype_bytes=db) == \
            jkvq.page_bytes(ps, kv, hd, bits, dtype_bytes=db)
        for budget in (10**5, 10**6, 3 * 10**7):
            try:
                want = jkvq.blocks_for_bytes(budget, ps, kv, hd, bits,
                                             dtype_bytes=db)
            except ValueError:
                with pytest.raises(ValueError):
                    kvq.blocks_for_bytes(budget, ps, kv, hd, bits,
                                         dtype_bytes=db)
                continue
            assert kvq.blocks_for_bytes(budget, ps, kv, hd, bits,
                                        dtype_bytes=db) == want
    assert kvq.vq_overhead_bytes(8) == jkvq.vq_overhead_bytes(8)


def test_storage_cols_and_infer_bits():
    for hd in (4, 16, 128):
        for bits in (8, 4, "vq2"):
            assert kvq.storage_cols(hd, bits) == jkvq.storage_cols(hd, bits)
    assert kvq.infer_bits(2, 2) == 8 and kvq.infer_bits(1, 2) == 4
    assert kvq.infer_bits(64, 64) == 8 and kvq.infer_bits(32, 64) == 4
    with pytest.raises(ValueError):
        kvq.infer_bits(3, 8)
    with pytest.raises(ValueError):
        kvq.storage_cols(6, "vq2")


def test_minus_eight_never_produced():
    x = torch.tensor([[-1.0, 1.0, -1.0, -0.99] * 4]).reshape(1, 1, 16)
    codes, _ = kvq.quantize_kv(x, 4)
    unpacked = kvq.unpack_int4(codes)
    assert int(unpacked.min()) >= -7 and int(unpacked.max()) <= 7


@pytest.mark.parametrize("bits", [8, 4, "vq2"])
def test_zero_rows_decode_to_zero(bits):
    x = torch.zeros((3, 2, 16))
    if bits == "vq2":
        cb = kvq.default_codebook(2)
        codes, scales = kvq.vq_quantize_rows(x, cb)
        dec = kvq.vq_dequant_rows(codes, scales, cb)
    else:
        codes, scales = kvq.quantize_kv(x, bits)
        dec = kvq.dequant_rows(codes, scales, bits)
    assert float(scales.abs().max()) == 0.0
    assert float(dec.abs().max()) == 0.0


def test_default_codebook_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 2, 16)).astype(np.float32))
    cb = kvq.default_codebook(2)
    codes, scales = kvq.vq_quantize_rows(x, cb)
    dec = kvq.vq_dequant_rows(codes, scales, cb)
    amax = x.abs().amax(dim=-1, keepdim=True)
    assert float(((dec - x).abs() / amax).max()) <= 1.0 / 3.0 + 1e-6
