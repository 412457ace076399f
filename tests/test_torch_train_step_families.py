"""The port's train step against the reference's on the moe (the aux loss
counts) and ssm (xLSTM: a list of layers, no weight decay on its 1-D
leaves) smoke configs, from the reference's init state on the same numpy
tokens, at microbatches 1 and 2 and every ``remat``; bars and helpers as
``test_torch_train_step.py``'s. The reference's ``make_train_step`` runs
at microbatches 2 (its compile is the cost); its gradients at 1 and 2.

The two packages' xLSTM forwards already differ by ~5e-6 relative (the
logits by 3.3e-6 here; ``test_torch_xlstm.py`` holds them at 1e-4), so the
ssm gradients are held at atol 1e-5 * max|g| (measured: at most 7.8e-6),
and its steps run at lr 1e-3: at the dense tests' 1e-2 the random xLSTM's
loss climbs from 6.23 to 7.49 in three steps and the two runs drift apart
by 2e-4 in the loss."""
import pytest
import torch

from test_torch_train_step import (
    OCFG, REMATS, check_grads_case, check_steps_case, reference_run)

FAMILIES = {"moe": "qwen3-moe-30b-a3b", "ssm": "xlstm-125m"}
KW = dict(dtype="float32")
LR = {"moe": OCFG["lr"], "ssm": 1e-3}
ATOL_FRAC = {"moe": 1e-6, "ssm": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def refs():
    return {fam: reference_run(arch, KW, (1, 2), jit_steps=(2,),
                               ocfg=dict(OCFG, lr=LR[fam]))
            for fam, arch in FAMILIES.items()}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grads_match_reference(refs, family, n_mb, remat):
    check_grads_case(refs[family], FAMILIES[family], KW, n_mb, remat,
                     ATOL_FRAC[family])


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_steps_match_reference(refs, family, remat):
    check_steps_case(refs[family], FAMILIES[family], KW, 2, remat)


def test_moe_aux_loss_is_in_the_loss(refs):
    """The moe step's loss is ce + aux: its loss and nll differ by more
    than the z-loss alone."""
    m = refs["moe"]["metrics"][2]
    assert m["loss"] - m["nll"] > 1e-3
