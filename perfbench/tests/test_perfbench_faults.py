"""The harness's judgement, driven through a whole run of a tiny cell on
the CPU with the timed path broken underneath: each fault a cell can have
turns ``correct`` false, and the sound run stays true. Neither kind has
optimizer state or an exchange between chips. A served cell's faults: a
token altered where it is produced, a step that leaves the cache's state
unchanged, half of the batch left out of the forward. A quantizer's: its
packed codes altered where they are made, a block's advance that returns
the activations unchanged, half of the calibration batch left out of the
Hessians (the mean taken over the rest)."""
import pytest
import torch

import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_sound_run_is_correct(root):
    _, rec, line = tiny.run(root)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def _altered_token(monkeypatch):
    from repro_torch.serve import sampling

    real = sampling.sample

    def sample(gen, logits, **kw):
        tok = real(gen, logits, **kw)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(sampling, "sample", sample)


def _cache_left_unchanged(monkeypatch):
    from repro_torch.models import attention

    real = attention._page_slots

    def page_slots(cache, pos_arr):
        blk, off = real(cache, pos_arr)
        return torch.zeros_like(blk), off       # every write to scratch

    monkeypatch.setattr(attention, "_page_slots", page_slots)


def _half_batch_left_out(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.forward

    def forward(params, cfg, tokens, **kw):
        B = tokens.shape[0]
        if B > 1:
            tokens = tokens.clone()
            tokens[B // 2:] = 0
        return real(params, cfg, tokens, **kw)

    monkeypatch.setattr(transformer, "forward", forward)


@pytest.mark.parametrize("fault", [_altered_token, _cache_left_unchanged,
                                   _half_batch_left_out])
def test_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    _, _, line = tiny.run(root)
    assert line["correct"] is False, line["checks"]


def test_sound_quantize_run_is_correct(root):
    _, _, line = tiny.run(root, cell=tiny.QCELL)
    assert line["correct"] is True, line["checks"]


def _codes_altered(monkeypatch):
    from repro_torch.core import vq_linear

    real = vq_linear.from_vq_result

    def from_vq_result(res):
        v = real(res)
        v.words.bitwise_xor_(0x11111111)    # every 4-bit code's low bit
        return v

    monkeypatch.setattr(vq_linear, "from_vq_result", from_vq_result)


def _advance_unchanged(monkeypatch):
    from repro_torch.core.adapters import transformer as ta

    monkeypatch.setattr(ta._DenseBlock, "advance", lambda self, x: x)


def _half_calibration(monkeypatch):
    from repro_torch.core import hessian
    from repro_torch.models import moe

    real_acc, real_exp = hessian.accumulate, moe.expert_hessians

    def accumulate(state, x):
        return real_acc(state, x[: max(1, x.shape[0] // 2)])

    def expert_hessians(p, cfg, x, diag_only=False):
        return real_exp(p, cfg, x[: max(1, x.shape[0] // 2)], diag_only)

    monkeypatch.setattr(hessian, "accumulate", accumulate)
    monkeypatch.setattr(moe, "expert_hessians", expert_hessians)


@pytest.mark.parametrize("fault", [_codes_altered, _advance_unchanged,
                                   _half_calibration])
def test_quantize_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    _, _, line = tiny.run(root, cell=tiny.QCELL)
    assert line["correct"] is False, line["checks"]
