"""The port's train step (``repro_torch.train.train_step``) against the
reference's ``make_train_step``, from the reference's init state (through
``convert.train_state_from_jax``) on the same numpy tokens: the dense
family here (the reference's ``tiny_model``, and one case at S = 4096 so
that both packages take their flash paths: the reference's XLA scan under
``jax.grad``, the port's ``FlashAttentionFn``), moe and ssm in
``test_torch_train_step_families.py``; and mirrors of the reference's
``TestTrainStep`` inside the port.

Bars: loss and metrics within rtol 1e-5; each leaf's gradient within rtol
1e-4 and atol 1e-6 * max|g| of the leaf (f32 sums in another order); the
params after three steps within 1e-2 * lr (a wrong bias correction, clip
or decay moves a weight by about lr), element by element but for the few
elements whose gradient is rounding noise (``check_params``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train.train_step import init_state as j_init_state
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import model_zoo
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    init_state, loss_and_grads, make_train_step)

OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10)
MB_ROWS, SEQ, STEPS = 2, 32, 3  # rows a microbatch, tokens, steps
REMATS = (True, False, "save_attn")
DENSE_KW = dict(dtype="float32", n_layers=2, d_model=64, vocab_size=256,
                max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tokens_for(vocab: int, rows: int, seq: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def reference_run(arch: str, kw: dict, microbatches_list, seq: int = SEQ,
                  steps: int = STEPS, jit_steps=(1, 2), ocfg=OCFG,
                  seed_params=None, extras=None) -> dict:
    """The reference's numbers for one config, as numpy: its init state;
    per microbatch count (global batch MB_ROWS * microbatches, so every
    microbatch has one shape and one compiled gradient) the accumulated
    gradient and metrics of step 1, taken as its train step takes them,
    and, for the counts in ``jit_steps``, ``make_train_step``'s metrics
    and params after each of ``steps`` steps (optimizer ``ocfg``).
    ``seed_params`` rewrites the init params before the optimizer state is
    made from them; ``extras(cfg, rows, seed)`` gives a batch's leaves
    beside its tokens (numpy), split by microbatch as the tokens are."""
    cfg = JSMOKE[arch].scaled(**kw)
    model = jzoo.build(cfg)
    j_ocfg = jopt.OptConfig(**ocfg)
    state = j_init_state(model, jax.random.PRNGKey(0), j_ocfg)
    if seed_params is not None:
        params = seed_params(state.params)
        state = state._replace(params=params, opt=jopt.init(params, j_ocfg))

    def loss_fn(params, mb):
        logits, _, aux = model.forward(params, mb, remat=True)
        S = mb["tokens"].shape[1]
        ce, metrics = jloss.next_token_loss(
            logits[:, -S:, :].astype(jnp.float32), mb["tokens"])
        return ce + aux, metrics

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = {"cfg": cfg, "state": np_tree(state), "grads": {}, "metrics": {},
           "steps": {}, "tokens": {}, "extras": {}, "ocfg": ocfg}
    for n_mb in microbatches_list:
        rows = MB_ROWS * n_mb
        batches = [tokens_for(cfg.vocab_size, rows, seq, 10 * n_mb + i)
                   for i in range(steps)]
        more = [{} if extras is None else extras(cfg, rows, 10 * n_mb + i)
                for i in range(steps)]
        out["tokens"][n_mb], out["extras"][n_mb] = batches, more
        acc = jax.tree.map(jnp.zeros_like, state.params)
        mets = {"loss": 0.0, "nll": 0.0, "ppl_proxy": 0.0}
        for i in range(n_mb):
            rs = slice(i * MB_ROWS, (i + 1) * MB_ROWS)
            (l, m), g = vg(state.params, {
                "tokens": jnp.asarray(batches[0][rs]),
                **{k: jnp.asarray(x[rs]) for k, x in more[0].items()}})
            acc = jax.tree.map(lambda a, x: a + x / n_mb, acc, g)
            for k, x in dict(m, loss=l).items():
                mets[k] = mets[k] + float(x) / n_mb
        out["grads"][n_mb] = np_tree(acc)
        out["metrics"][n_mb] = mets
        if n_mb in jit_steps:
            step = jax.jit(j_make_train_step(model, j_ocfg,
                                             microbatches=n_mb))
            st, trace = state, []
            for b, e in zip(batches, more):
                st, m = step(st, {"tokens": jnp.asarray(b),
                                  **{k: jnp.asarray(x) for k, x in e.items()}})
                trace.append({k: float(v) for k, v in m.items()})
            out["steps"][n_mb] = (trace, np_tree(st.params))
    return out


def port_batch(ref: dict, n_mb: int, i: int) -> dict:
    """Step ``i``'s batch of ``reference_run`` as the port's tensors."""
    return {"tokens": torch.from_numpy(ref["tokens"][n_mb][i]).long(),
            **{k: torch.from_numpy(x)
               for k, x in ref["extras"][n_mb][i].items()}}


def leaves(tree) -> list:
    return opt.tree_leaves(tree)


def names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in names(v, f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in names(v, f"{prefix}[{i}]")]
    return [prefix]


def port_model(arch: str, kw: dict):
    cfg = SMOKE[arch].scaled(**kw)
    return cfg, model_zoo.build(cfg)


def check_grads(port_grads, ref_np_grads, cfg, atol_frac: float = 1e-6,
                leaf_atol_frac: dict | None = None):
    """Each leaf within rtol 1e-4 and atol ``atol_frac`` * max|g| of the
    leaf (a leaf whose last name part is a key of ``leaf_atol_frac``: that
    fraction), and within 1e-5 relative Frobenius. A leaf whose gradient is
    zero but for rounding (the xLSTM's input-gate biases b_i: the
    stabilized exponential gate cancels a shift of its pre-activation;
    ~1e-9 against a tree max of ~1) is held instead to 1e-8 of the tree's
    max|g|."""
    want = params_from_jax(ref_np_grads, cfg, "cpu", keep_dtype=True)
    assert names(port_grads) == names(want)
    floor = 1e-8 * max(float(w.abs().max()) for w in leaves(want))
    for name, g, w in zip(names(want), leaves(port_grads), leaves(want)):
        frac = (leaf_atol_frac or {}).get(name.rsplit(".", 1)[-1], atol_frac)
        atol = max(frac * float(w.abs().max()), floor)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        assert (float((g - w).norm()) <= 1e-5 * float(w.norm())
                + atol * w.numel() ** 0.5), name


def check_metrics(got: dict, want: dict):
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), w, rtol=1e-5, err_msg=k)


def check_grads_case(ref: dict, arch: str, kw: dict, n_mb: int, remat,
                     atol_frac: float = 1e-6,
                     leaf_atol_frac: dict | None = None):
    cfg, model = port_model(arch, kw)
    state = train_state_from_jax(ref["state"], cfg, "cpu")
    grads, metrics = loss_and_grads(model, state.params,
                                    port_batch(ref, n_mb, 0),
                                    microbatches=n_mb, remat=remat)
    check_metrics(metrics, ref["metrics"][n_mb])
    check_grads(grads, ref["grads"][n_mb], cfg, atol_frac, leaf_atol_frac)


def check_steps_case(ref: dict, arch: str, kw: dict, n_mb: int, remat,
                     off_per_mille: int = 1):
    cfg, model = port_model(arch, kw)
    state = train_state_from_jax(ref["state"], cfg, "cpu")
    step = make_train_step(model, opt.OptConfig(**ref["ocfg"]),
                           microbatches=n_mb, remat=remat)
    trace_want, params_want = ref["steps"][n_mb]
    for i, want in enumerate(trace_want):
        state, metrics = step(state, port_batch(ref, n_mb, i))
        check_metrics(metrics, {k: want[k] for k in
                                ("loss", "nll", "ppl_proxy", "lr")})
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   want["grad_norm"], rtol=1e-4)
    grads = params_from_jax(ref["grads"][n_mb], cfg, "cpu", keep_dtype=True)
    check_params(state.params, params_from_jax(params_want, cfg, "cpu"),
                 ref["ocfg"]["lr"], grads, off_per_mille)


def check_params(got, want, lr: float, grads, off_per_mille: int = 1):
    """The params after the steps: each leaf's RMS difference within
    5e-3 * lr, and every element within 1e-2 * lr but for at most
    ``off_per_mille`` in 1,000 of the tree's elements. Adam divides the clipped gradient by its
    own magnitude plus eps = 1e-8, so an element whose gradient is a few
    1e-8 after clipping (a sum that cancels to rounding noise, where the
    packages' f32 sums differ by ~10%) moves by up to ~0.1 lr more or less
    in one package than in the other; a wrong bias correction, clip or
    decay moves every element by about lr. A leaf whose step-1 gradient
    (``grads``) is rounding noise (see ``check_grads``) moves by
    noise / eps in each package: only its elements count."""
    floor = 1e-8 * max(float(g.abs().max()) for g in leaves(grads))
    n_off = n_all = 0
    for name, a, b, g in zip(names(want), leaves(got), leaves(want),
                             leaves(grads)):
        d = (a - b).abs()
        n_off += int((d > 1e-2 * lr).sum())
        n_all += d.numel()
        if float(g.abs().max()) > floor:
            assert float(d.pow(2).mean().sqrt()) <= 5e-3 * lr, name
    assert n_off * 1000 <= n_all * off_per_mille, (n_off, n_all)


@pytest.fixture(scope="module")
def dense_ref():
    return reference_run("llama2-7b", DENSE_KW, (1, 2))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("n_mb", [1, 2])
def test_dense_grads_match_reference(dense_ref, n_mb, remat):
    check_grads_case(dense_ref, "llama2-7b", DENSE_KW, n_mb, remat)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("n_mb", [1, 2])
def test_dense_steps_match_reference(dense_ref, n_mb, remat):
    check_steps_case(dense_ref, "llama2-7b", DENSE_KW, n_mb, remat)


LONG_KW = dict(DENSE_KW, n_layers=1, max_seq_len=4096)
LONG_SEQ = 4096


@pytest.fixture(scope="module")
def long_ref():
    return reference_run("llama2-7b", LONG_KW, (1,), seq=LONG_SEQ, steps=1,
                         jit_steps=())


def test_dense_at_4096_tokens_through_both_flash_paths(long_ref):
    """S = 4096: the reference differentiates its XLA flash scan, the port
    runs FlashAttentionFn (plain forward and backward on the CPU); the
    gradients of wq, wk and wv come only through it. Each gradient sums
    over 8,192 positions (128 times the smoke cases'), so its elementwise
    atol is 1e-5 * max|g|; the relative Frobenius bar stays 1e-5. (The
    Function's backward agrees with autograd through the plain scan to
    ~6e-7 relative Frobenius on the same tokens: what is left is the two
    frameworks' f32 sums.)"""
    from repro_torch.kernels import flash_attention as fa

    cfg, model = port_model("llama2-7b", LONG_KW)
    calls = []
    orig = fa.FlashAttentionFn.backward

    def spy(ctx, dout):
        calls.append(dout.shape)
        return orig(ctx, dout)

    fa.FlashAttentionFn.backward = staticmethod(spy)
    try:
        check_grads_case(long_ref, "llama2-7b", LONG_KW, 1, True,
                         atol_frac=1e-5)
    finally:
        fa.FlashAttentionFn.backward = staticmethod(orig)
    assert len(calls) == 1  # one layer, one microbatch
    assert calls[0] == (MB_ROWS, LONG_SEQ, cfg.n_heads, cfg.hd)


# ---------------------------------------------------------------------------
# mirrors of the reference's TestTrainStep, inside the port
# ---------------------------------------------------------------------------

def tiny_model():
    return model_zoo.build(SMOKE["llama2-7b"].scaled(**DENSE_KW))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_decreases(microbatches):
    from repro_torch.data.synthetic import SyntheticStream

    model = tiny_model()
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=40)
    state = init_state(model, 0, ocfg, device="cpu")
    step = make_train_step(model, ocfg, microbatches=microbatches)
    stream = SyntheticStream(model.cfg.vocab_size, seq_len=32,
                             global_batch=4)
    losses = []
    for _ in range(12):
        state, metrics = step(state, {"tokens": stream.next()})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_microbatch_equivalence():
    """grad accumulation over k microbatches == single big batch."""
    from repro_torch.data.synthetic import sample_batch

    model = tiny_model()
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    state = init_state(model, 0, ocfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": sample_batch(gen, model.cfg.vocab_size, 32, 4)}
    st1, m1 = make_train_step(model, ocfg, microbatches=1)(state, batch)
    st2, m2 = make_train_step(model, ocfg, microbatches=2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    d = max(float((a - b).abs().max()) for a, b in zip(
        leaves(st1.params), leaves(st2.params)))
    assert d < 1e-4


def test_train_step_leaves_its_input_state_unchanged():
    model = tiny_model()
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    state = init_state(model, 0, ocfg, device="cpu")
    before = [t.clone() for t in leaves(state.params) + leaves(state.opt.m)]
    toks = torch.from_numpy(tokens_for(model.cfg.vocab_size, 2, 16, 0)).long()
    make_train_step(model, ocfg)(state, {"tokens": toks})
    after = leaves(state.params) + leaves(state.opt.m)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.opt.step) == 0


def test_grad_accumulator_in_bf16():
    """grad_accum_dtype bf16: each microbatch's gradient / 2 is rounded to
    bf16 and summed in bf16, as the reference's accumulator does."""
    model = tiny_model()
    params = model.init_params(seed=0, device="cpu")
    toks = torch.from_numpy(tokens_for(model.cfg.vocab_size, 4, 16, 1)).long()
    g16, m16 = loss_and_grads(model, params, {"tokens": toks},
                              microbatches=2, grad_accum_dtype="bfloat16")
    halves = [loss_and_grads(model, params, {"tokens": toks[i:i + 2]})[0]
              for i in (0, 2)]
    g32, m32 = loss_and_grads(model, params, {"tokens": toks},
                              microbatches=2)
    assert float(m16["loss"]) == float(m32["loss"])
    for a, h0, h1 in zip(leaves(g16), *map(leaves, halves)):
        want = torch.zeros_like(a)
        for h in (h0, h1):
            want = want + (h / 2).to(torch.bfloat16)
        assert a.dtype == torch.bfloat16 and torch.equal(a, want)
