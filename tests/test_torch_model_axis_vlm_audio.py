"""The mesh's model axis for the vlm (Phi-3-vision: the dense stack with
patch embeddings prepended after the vocabulary-split lookup) and audio
(whisper: encoder, decoder self- and cross-attention on the rank's heads,
MLPs on its hidden units, the tied embedding on its vocabulary rows)
families: their smoke configs on one ``torchrun`` group of 2 gloo CPU
ranks (``ranks.py``, ``model_axis_worker.py``) at meshes (1, 2) and
(2, 1), against the port's single device and the reference's step; the
vlm once more at 3,072 positions through ``FlashAttentionFn`` on the
rank's heads. Cases, bars and inputs: ``model_axis_families.py``.
"""
import functools

import pytest
import torch

from repro_torch.models import attention
from repro_torch.models import parallel as par

import model_axis_families as maf

FLASH_KW = dict(maf.KW, n_layers=1, max_seq_len=4096)
CASES = {  # name -> a function making the case
    "vlm_1x2": lambda: maf.step_case("vlm", (1, 2), True),
    "vlm_2x1": lambda: maf.step_case("vlm", (2, 1), "save_attn"),
    "vlm_flash_1x2": lambda: maf.flash_case("vlm", FLASH_KW, "save_attn"),
    "audio_1x2": lambda: maf.step_case("audio", (1, 2), True),
    "audio_2x1": lambda: maf.step_case("audio", (2, 1), False),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def case(name: str) -> dict:
    return CASES[name]()


@functools.lru_cache(maxsize=None)
def single(name: str) -> dict:
    return maf.single_device(case(name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on one group of 2 ranks; the reference's steps compile
    while it runs."""
    tmp = tmp_path_factory.mktemp("model_axis_vlm_audio")
    proc = maf.start_worker(tmp, [case(n) for n in CASES])
    for family in ("vlm", "audio"):
        maf.reference(family)
    for name in CASES:
        single(name)
    maf.ranks.finish({"world2": proc})
    return tmp


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_single_device(runs, name):
    c = case(name)
    maf.check_single_device(maf.result(runs, name), single(name),
                            name.split("_")[0], c["ocfg"]["lr"])


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_sharded_step_matches_reference(runs, family):
    maf.check_reference(maf.result(runs, f"{family}_1x2"), family)


@pytest.mark.parametrize("name,flash", [
    ("vlm_flash_1x2", 1),  # save_attn, one layer: attention once
    ("vlm_1x2", 0), ("audio_1x2", 0)])
def test_flash_calls_under_the_mesh(runs, name, flash):
    """The flash path at 3,072 positions (16 patches + 3,056 tokens) on
    the rank's 2 heads, by its count in the gradient pass; none at 32
    tokens."""
    assert maf.result(runs, name)["calls"] == {"flash": flash, "ep": 0}
    assert attention.FLASH_THRESHOLD < maf.FLASH_POSITIONS


def test_audio_reads_its_heads_and_vocabulary_rows(runs):
    """At (1, 2) whisper's 4 heads and 4 KV heads split 2 a rank: every
    attention leaf, the cross-attention's included, is read as the rank's
    shard; the tied embedding as its vocabulary rows; the positional
    tables and norms whole."""
    modes = maf.result(runs, "audio_1x2")["modes"]
    assert modes["embed"] == par.SPLIT
    assert modes["pos_enc"] == modes["pos_dec"] == par.FULL
    cross = {n.rsplit(".", 1)[1]: m for n, m in modes.items()
             if n.startswith("dec_layers.1.cross_attn.")}
    assert cross == {k: par.SPLIT for k in ("wq", "wk", "wv", "wo", "bq",
                                            "bk", "bv")}
    assert {m for n, m in modes.items() if "norm" in n} == {par.FULL}
