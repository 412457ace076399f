"""What ``test_torch_model_axis_vlm_audio.py`` and
``test_torch_model_axis_hybrid_ssm.py`` share: the families' cases on
the mesh's model axis, their reference inputs, the port's single-device
runs they are held to, and the checks.

Each family trains its fp32 smoke config from the reference's init state
(the hybrid's LoRA B and audio's q/k/v biases seeded non-zero, numpy seed
0, as ``test_torch_train_step_hybrid_audio.py`` seeds them) on the same
numpy tokens as ``test_torch_train_step.reference_run`` at microbatches 2
(global batch 4, the vlm's patches and audio's frames beside them), at
meshes (1, 2) and (2, 1). The vlm and the hybrid add a case at 3,072
positions on (1, 2), past ``attention.FLASH_THRESHOLD``, whose
``FlashAttentionFn`` calls the worker counts.

Bars, as ``test_torch_model_axis.py``'s against the port's single device:
step 1's loss, nll and lr rtol 1e-6 (later steps and ppl_proxy 1e-5), the
gradients rtol 1e-5 with atol 1e-6 * max of the leaf, three steps' params
by ``check_params``; where the split's reordered f32 sums read more, the
gradients' atol is the family's bar against the reference (read on the
CPU, worst leaf over max|g| of the leaf: audio 1.32e-6, a decoder
self-attention wk; ssm 7.56e-6 at (1, 2) and 6.86e-6 at (2, 1), the data
split alone; the hybrid 1.48e-6 off its scan leaves, which read up to
3.08e-5 at 32 tokens and 1.37e-4 at 3,072 positions, ``A_log``, held at
PERF.md section 2's 3.3e-4); the xLSTM's ``b_i``, zero but for rounding,
read 1.41e-8 of the tree's max at (2, 1), held at 1e-7. Against the reference, each family's own
bars (``FAMILIES``: the dense file's for the vlm,
``test_torch_train_step_hybrid_audio.py``'s for hybrid and audio,
``test_torch_train_step_families.py``'s for ssm).
"""
import functools
import pathlib
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import model_zoo
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainState, loss_and_grads, make_train_step)

import ranks
from test_torch_encdec import seeded_biases
from test_torch_hybrid import seeded_lora_b
from test_torch_train_step import (
    MB_ROWS, OCFG, SEQ, STEPS, check_grads, check_metrics, check_params,
    names, np_tree, reference_run, tokens_for)
from test_torch_train_step_hybrid_audio import frames_for

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(dtype="float32")
FLASH_POSITIONS = 3072  # past attention.FLASH_THRESHOLD


def patches_for(cfg, rows: int, seed: int) -> dict:
    """The stub vision tower's patch embeddings (rows, n_image_tokens,
    d_model), drawn with numpy."""
    rng = np.random.default_rng(200 + seed)
    return {"patches": (rng.standard_normal(
        (rows, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)}


class Family(NamedTuple):
    arch: str
    seed_params: Any       # the reference's init params -> seeded ones
    extras: Any            # (cfg, rows, seed) -> a batch's other leaves
    lr: float
    atol_frac: float       # check_grads' against the reference
    leaf_atol_frac: Any
    off_per_mille: int     # check_params' against the reference
    single_atol_frac: float  # the gradients' against the port's single
    single_leaf_atol: Any    # device, as atol_frac and leaf_atol_frac,
    single_floor: float      # and close's floor_frac


# the hybrid's per-head scan leaves sum over every position with
# cancellation: any reordered f32 sum moves them (PERF.md section 2)
SCAN_LEAVES = {k: 3.3e-4 for k in ("A_log", "dt_bias", "D_skip")}
FAMILIES = {
    "vlm": Family("phi-3-vision-4.2b", None, patches_for, OCFG["lr"], 1e-6,
                  None, 1, 1e-6, None, 1e-8),
    "audio": Family("whisper-small", seeded_biases, frames_for, OCFG["lr"],
                    5e-6, None, 2, 5e-6, None, 1e-8),
    "hybrid": Family("zamba2-7b", seeded_lora_b, None, OCFG["lr"], 5e-6,
                     {"A_log": 5e-5}, 1, 5e-6, SCAN_LEAVES, 1e-8),
    "ssm": Family("xlstm-125m", None, None, 1e-3, 1e-5, None, 1, 1e-5,
                  None, 1e-7),
}


def ocfg(family: str) -> dict:
    return dict(OCFG, lr=FAMILIES[family].lr)


@functools.lru_cache(maxsize=None)
def ref_inputs(family: str):
    """``reference_run``'s init params (seeded, as the port's) and its
    three batches at microbatches 2 (tokens and extras, numpy), without
    compiling its steps: the ranks start on these while the reference
    compiles."""
    import jax

    from repro.configs import SMOKE as JSMOKE
    from repro.models import model_zoo as jzoo
    from repro.train import optimizer as jopt
    from repro.train.train_step import init_state as j_init_state

    fam = FAMILIES[family]
    jcfg = JSMOKE[fam.arch].scaled(**KW)
    j_ocfg = jopt.OptConfig(**ocfg(family))
    state = j_init_state(jzoo.build(jcfg), jax.random.PRNGKey(0), j_ocfg)
    if fam.seed_params is not None:
        p = fam.seed_params(state.params)
        state = state._replace(params=p, opt=jopt.init(p, j_ocfg))
    params = train_state_from_jax(np_tree(state), SMOKE[fam.arch].scaled(
        **KW), "cpu").params
    rows = MB_ROWS * 2
    tokens = [tokens_for(jcfg.vocab_size, rows, SEQ, 20 + i)
              for i in range(STEPS)]
    extras = [{} if fam.extras is None else fam.extras(jcfg, rows, 20 + i)
              for i in range(STEPS)]
    return params, tokens, extras


@functools.lru_cache(maxsize=None)
def reference(family: str) -> dict:
    fam = FAMILIES[family]
    return reference_run(fam.arch, KW, (2,), jit_steps=(2,),
                         ocfg=ocfg(family), seed_params=fam.seed_params,
                         extras=fam.extras)


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def step_case(family: str, mesh, remat) -> dict:
    params, tokens, extras = ref_inputs(family)
    return dict(kind="step", name=f"{family}_{mesh[0]}x{mesh[1]}",
                arch=FAMILIES[family].arch, kw=KW, mesh=mesh, params=params,
                tokens=[torch.from_numpy(t).long() for t in tokens],
                extras=[_torch(e) for e in extras], microbatches=2,
                remat=remat, ocfg=ocfg(family))


def flash_case(family: str, kw: dict, remat) -> dict:
    """One step at (1, 2) on a row of ``FLASH_POSITIONS`` positions (the
    vlm's text after its patches), from the port's init (seed 0; the
    hybrid's LoRA B drawn non-zero)."""
    fam = FAMILIES[family]
    cfg = SMOKE[fam.arch].scaled(**kw)
    params = model_zoo.build(cfg).init_params(seed=0, device="cpu")
    rng = np.random.default_rng(3)
    if family == "hybrid":
        for f in params["lora"].values():
            f["B"] = torch.from_numpy(rng.standard_normal(
                tuple(f["B"].shape)).astype(np.float32) * 0.02)
    text = FLASH_POSITIONS - (cfg.n_image_tokens if family == "vlm" else 0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, text))).long()
    extras = ([{"patches": torch.from_numpy(patches_for(cfg, 1, 3)[
        "patches"])}] if family == "vlm" else None)
    return dict(kind="step", name=f"{family}_flash_1x2", arch=fam.arch,
                kw=kw, mesh=(1, 2), params=params, tokens=[tokens],
                extras=extras, microbatches=1, remat=remat,
                ocfg=ocfg(family))


def start_worker(tmp: pathlib.Path, cases: list, world: int = 2):
    """The worker on ``world`` ranks over ``cases`` (started, not
    waited for); its outputs under ``tmp / "out"``."""
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    torch.save(cases, tmp / "cases.pt")
    return ranks.start(ranks.torchrun(
        world, ROOT / "tests" / "model_axis_worker.py", tmp / "cases.pt",
        out))


def result(tmp: pathlib.Path, name: str) -> dict:
    return torch.load(tmp / "out" / f"{name}.pt", weights_only=False)


def single_device(case: dict) -> dict:
    """The port's step on one device from the case's params and batches:
    step 1's gradients and metrics, then ``len(tokens)`` steps."""
    cfg = SMOKE[case["arch"]].scaled(**case["kw"])
    model = model_zoo.build(cfg)
    ocfg_ = opt.OptConfig(**case["ocfg"])
    mb, remat = case["microbatches"], case["remat"]
    extras = case.get("extras") or [{} for _ in case["tokens"]]
    batches = [{"tokens": t, **e} for t, e in zip(case["tokens"], extras)]
    params = case["params"]
    grads, m1 = loss_and_grads(model, params, batches[0], microbatches=mb,
                               remat=remat)
    state = TrainState(params, opt.init(params, ocfg_))
    step = make_train_step(model, ocfg_, microbatches=mb, remat=remat)
    trace = []
    for b in batches:
        state, m = step(state, b)
        trace.append({k: float(v) for k, v in m.items()})
    return {"grads": grads, "metrics": {k: float(v) for k, v in m1.items()},
            "trace": trace, "params": state.params}


def close(got, want, rtol: float = 1e-5, atol_frac: float = 1e-6,
          leaf_atol_frac: dict | None = None, floor_frac: float = 1e-8,
          what: str = ""):
    """Each leaf within ``rtol`` and ``atol_frac`` * max of the leaf (a
    leaf whose last name part is a key of ``leaf_atol_frac``: that
    fraction); a leaf whose
    gradient is zero but for rounding (audio's key biases ``bk``: a shift
    of every score of a query row, which the softmax cancels; the xLSTM's
    ``b_i``) within ``floor_frac`` of the tree's max, as
    ``test_torch_train_step.check_grads`` holds it."""
    floor = floor_frac * max(float(b.abs().max()) for b in opt.tree_leaves(want))
    for n, a, b in zip(names(want), opt.tree_leaves(got),
                       opt.tree_leaves(want)):
        frac = (leaf_atol_frac or {}).get(n.rsplit(".", 1)[-1], atol_frac)
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=max(frac * float(b.abs().max()), floor),
            msg=lambda m, n=n: f"{what}{n}: {m}")


def check_single_device(got: dict, want: dict, family: str, lr: float):
    """A sharded run against the port's single device, by
    ``test_torch_model_axis.py``'s bars; the gradients' atol is the
    family's ``single_atol_frac``."""
    rtol = {"loss": 1e-6, "nll": 1e-6, "lr": 1e-6, "ppl_proxy": 1e-5,
            "grad_norm": 1e-5}
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=rtol[k],
                                   err_msg=k)
    assert len(got["trace"]) == len(want["trace"])
    for i, (g, w) in enumerate(zip(got["trace"], want["trace"])):
        for k in rtol:
            np.testing.assert_allclose(g[k], w[k], rtol=max(
                rtol[k], 1e-5 if i else 0), err_msg=f"step {i + 1} {k}")
    fam = FAMILIES[family]
    close(got["grads"], want["grads"], atol_frac=fam.single_atol_frac,
          leaf_atol_frac=fam.single_leaf_atol, floor_frac=fam.single_floor,
          what="grad ")
    check_params(got["params"], want["params"], lr, want["grads"])


def check_reference(got: dict, family: str):
    """A sharded run at (1, 2) against the reference's step on the same
    inputs, by the family's own bars."""
    fam = FAMILIES[family]
    ref = reference(family)
    cfg = SMOKE[fam.arch].scaled(**KW)
    _, tokens, _ = ref_inputs(family)
    assert all(np.array_equal(a, b) for a, b in zip(tokens,
                                                    ref["tokens"][2]))
    check_metrics(got["metrics"], ref["metrics"][2])
    check_grads(got["grads"], ref["grads"][2], cfg, fam.atol_frac,
                fam.leaf_atol_frac)
    trace, params = ref["steps"][2]
    for g, w in zip(got["trace"], trace):
        check_metrics(g, {k: w[k] for k in ("loss", "nll", "lr")})
    check_params(got["params"], params_from_jax(params, cfg, "cpu"), fam.lr,
                 params_from_jax(ref["grads"][2], cfg, "cpu",
                                 keep_dtype=True), fam.off_per_mille)
