"""The port's train step against the reference's on the hybrid (Zamba2:
groups of Mamba2 layers behind the shared attention block with its
per-group LoRA) and audio (whisper: encoder and decoder layers, frames
beside the tokens) smoke configs, from the reference's init state on the
same numpy tokens (and, for audio, the same numpy frames: the port's
``synth_frames`` stream is not the reference's), at microbatches 1 and 2
and every ``remat``; bars and helpers as ``test_torch_train_step.py``'s.

The reference initialises the LoRA B factors and the q/k/v biases at
zeros, where a wrong group slice or a bias on the wrong side changes no
gradient: both packages start here from the same non-zero draws
(``seeded_lora_b``, ``seeded_biases``; numpy seed 0, std 0.02).

``remat=True`` checkpoints a hybrid group and each audio layer (its
gradients against ``remat=False``'s: ``test_torch_train_runtime.py``).

Bars are the dense file's, widened where a reading asked for it:
* hybrid ``A_log`` gradients at atol 5e-5 * max|g| of the leaf (dense:
  1e-6). They sum decays over every position with cancellation; the two
  packages' f32 scans differ there by up to 1.75e-5 * max|g| of the leaf.
  ``test_ssd_chunked_gradients_match_the_sequential_oracle`` holds the
  port's scan under autograd to the sequential recurrence, so what is
  left is the packages' f32 sums.
* every other hybrid leaf at atol 5e-6 * max|g| (read: 2.35e-6 on the
  LoRA ``q.A``, 1.2-1.4e-6 on the shared q/k/v and the other LoRA
  factors; ``dt_bias`` and ``D_skip`` pass at rtol alone): the scans'
  reordered sums reach every leaf through the residual stream.
* audio gradients at atol 5e-6 * max|g| (read: 1.37e-6, one element of a
  cross-attention ``wk``).
* audio params after the steps: at most 2 in 1,000 elements off (dense:
  1; read: 229 of 208,768, all but one in the ``bk`` leaves). A key bias
  shifts every score of a query row by the same q.b, which the softmax
  cancels, so ``bk``'s gradient is zero but for rounding in both
  packages, and Adam moves each of its elements by about +-lr on noise:
  its 384 elements are 1.84 in 1,000 of the smoke tree."""
import numpy as np
import pytest
import torch

from test_torch_encdec import seeded_biases
from test_torch_hybrid import seeded_lora_b
from test_torch_train_step import (
    OCFG, REMATS, check_grads_case, check_steps_case, leaves, names,
    port_batch, port_model, reference_run)

from repro_torch.convert import train_state_from_jax
from repro_torch.models import ssm
from repro_torch.train.train_step import loss_and_grads

FAMILIES = {"hybrid": "zamba2-7b", "audio": "whisper-small"}
KW = dict(dtype="float32")
SEED = {"hybrid": seeded_lora_b, "audio": seeded_biases}
ATOL_FRAC = {"hybrid": 5e-6, "audio": 5e-6}
LEAF_ATOL_FRAC = {"hybrid": {"A_log": 5e-5}, "audio": None}
OFF_PER_MILLE = {"hybrid": 1, "audio": 2}


def frames_for(cfg, rows: int, seed: int) -> dict:
    """The stub frontend's frame embeddings (rows, encoder_seq, d_model),
    drawn with numpy."""
    rng = np.random.default_rng(100 + seed)
    return {"frames": (rng.standard_normal(
        (rows, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)}


EXTRAS = {"hybrid": None, "audio": frames_for}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def refs():
    return {fam: reference_run(arch, KW, (1, 2), jit_steps=(2,),
                               seed_params=SEED[fam], extras=EXTRAS[fam])
            for fam, arch in FAMILIES.items()}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grads_match_reference(refs, family, n_mb, remat):
    check_grads_case(refs[family], FAMILIES[family], KW, n_mb, remat,
                     ATOL_FRAC[family], LEAF_ATOL_FRAC[family])


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_steps_match_reference(refs, family, remat):
    check_steps_case(refs[family], FAMILIES[family], KW, 2, remat,
                     OFF_PER_MILLE[family])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_seeded_leaves_carry_gradient(refs, family):
    """The seeded factors are non-zero in the port's state, and the LoRA
    A factors (hybrid) and q/k/v biases (audio) get a gradient: zero B
    factors would leave every A gradient at zero."""
    ref = refs[family]
    cfg, model = port_model(FAMILIES[family], KW)
    state = train_state_from_jax(ref["state"], cfg, "cpu")
    grads, _ = loss_and_grads(model, state.params, port_batch(ref, 1, 0))
    pick = ((".lora.", ".A") if family == "hybrid" else (".bq", ".bk", ".bv"))
    seeded = ((".lora.", ".B") if family == "hybrid"
              else (".bq", ".bk", ".bv"))

    def chosen(tree, parts):
        return [t for n, t in zip(names(tree), leaves(tree))
                if (all(p in n for p in parts) if family == "hybrid"
                    else n.endswith(parts))]

    assert all(float(t.abs().max()) > 0 for t in chosen(state.params, seeded))
    got = chosen(grads, pick)
    assert got and all(float(t.abs().max()) > 0 for t in got)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_gradients_match_the_sequential_oracle(chunk):
    """``ssm._ssd_chunked`` under ``torch.autograd.grad`` (its in-place
    writes into the intra-chunk buffer included) against the sequential
    recurrence ``ssd_reference`` on the same inputs: the gradients of a
    random projection of y and of the final state with respect to every
    input, A included, at four chunks and at one."""
    rng = np.random.default_rng(3)
    Bsz, S, P, hd, N = 2, 32, 3, 4, 5

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(rng.standard_normal(shape) * scale + offset,
                            dtype=torch.float32, requires_grad=True)

    xh, Bm, Cm = t(Bsz, S, P, hd), t(Bsz, S, N), t(Bsz, S, N)
    dt = torch.tensor(rng.uniform(0.05, 0.5, (Bsz, S, P)),
                      dtype=torch.float32, requires_grad=True)
    A = torch.tensor(-rng.uniform(0.5, 2.0, (P,)), dtype=torch.float32,
                     requires_grad=True)
    wy = torch.tensor(rng.standard_normal((Bsz, S, P, hd)),
                      dtype=torch.float32)
    wh = torch.tensor(rng.standard_normal((Bsz, P, hd, N)),
                      dtype=torch.float32)
    inputs = (xh, Bm, Cm, dt, A)

    def grads(fn, *extra):
        y, h = fn(*inputs, *extra)
        return torch.autograd.grad((y * wy).sum() + (h * wh).sum(), inputs)

    got = grads(ssm._ssd_chunked, chunk)
    want = grads(ssm.ssd_reference)
    for name, g, w in zip(("xh", "Bm", "Cm", "dt", "A"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
