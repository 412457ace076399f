"""The port's ``data/calibration.from_token_file`` against the reference's
on the same ``.npy`` file: the same tokens exactly, and both refuse a file
shorter than n_sequences * seq_len tokens."""
import numpy as np
import pytest
import torch

from repro.data.calibration import from_token_file as j_from_token_file
from repro_torch.data.calibration import from_token_file


def _write(tmp_path, arr) -> str:
    path = str(tmp_path / "tokens.npy")
    np.save(path, arr)
    return path


@pytest.mark.parametrize("dtype,shape,n,seq", [
    (np.int32, (1000,), 4, 37),       # longer than needed: the head is kept
    (np.int64, (512,), 8, 64),        # exactly n * seq tokens
    (np.uint16, (3, 300), 5, 160),    # 2-D file, read flat
    (np.int64, (2000,), 1, 1),
])
def test_from_token_file_matches_reference(tmp_path, dtype, shape, n, seq):
    rng = np.random.default_rng(n + seq)
    arr = rng.integers(0, 32000, size=shape).astype(dtype)
    path = _write(tmp_path, arr)
    got = from_token_file(path, n, seq, device="cpu")
    want = np.asarray(j_from_token_file(path, n, seq))
    assert got.shape == (n, seq) == want.shape
    assert got.device.type == "cpu" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_from_token_file_keeps_the_reference_int32_read(tmp_path):
    """Values past int32 wrap as the reference's ``astype(np.int32)``."""
    arr = np.array([2**31 + 5, -7, 2**40 + 3, 11], dtype=np.int64)
    path = _write(tmp_path, arr)
    got = from_token_file(path, 2, 2, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_from_token_file(path, 2, 2)))


@pytest.mark.parametrize("size,n,seq", [(100, 4, 26), (0, 1, 1)])
def test_from_token_file_refuses_a_short_file(tmp_path, size, n, seq):
    path = _write(tmp_path, np.arange(size, dtype=np.int32))
    with pytest.raises(AssertionError, match="token file too small"):
        j_from_token_file(path, n, seq)
    with pytest.raises(ValueError, match="token file too small"):
        from_token_file(path, n, seq, device="cpu")
