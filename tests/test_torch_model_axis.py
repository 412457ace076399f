"""The mesh's model axis on the CPU: the sharded train step
(``train_step.make_train_step(mesh=)``, ``models/parallel``) at meshes
(1, 2), (2, 1), (2, 2) and (1, 4), expert parallelism (``moe._apply_ep``),
sharded checkpoints (``restore(shardings=)``,
``elastic.reshard``), ``supervise`` across ranks and the launcher's
``--model-parallel`` under ``torchrun`` and under ``COORDINATOR_ADDRESS``.

The ranks are ``torchrun`` groups of 2 and 4 gloo CPU ranks
(``model_axis_worker.py``), each started once; the 4-rank group first (it
writes the checkpoint the 2-rank group restores), then the 2-rank group
beside the ``COORDINATOR_ADDRESS`` launcher run, then the torchrun
launcher run. The reference's ``_apply_ep`` runs in a
subprocess on 4 forced host devices under ``with mesh:``, its keep masks
read through a ``jax.debug.callback`` on its ``jnp.where(keep, ...)``.

Bars: a sharded step against the port's single-device step (the same
arithmetic, sums split across ranks): step 1's loss, nll and lr rtol 1e-6
(steps 2 and 3 from params that carry Adam's noise below: 1e-5; ppl_proxy
= exp(nll) rtol 1e-5: exp turns nll's absolute error, ~6 x its relative
one, into a relative one), the gradients rtol 1e-5, atol 1e-6 * max of the
leaf; the params after three steps by ``check_params`` (Adam divides each
gradient by its own magnitude, so an element whose gradient cancels to
rounding noise moves by up to ~lr more or less in either run: measured
up to 1.1e-2 lr on a few embedding rows, which rtol 1e-5 cannot hold).
Against the reference's step, ``test_torch_train_step``'s
``check_grads`` / ``check_params`` / ``check_metrics``. Expert parallelism
is not the single-device dispatch (``moe``'s docstring): a sharded moe
step with a model axis > 1 is held to the single-device step with
``moe.apply`` replaced by ``_apply_ep_plain`` at the mesh's (tp, dp), and
the reference's ``_apply_ep`` holds the dispatch itself, keep masks
exactly, with a capacity that drops pairs.
"""
import contextlib
import functools
import io
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import common as cm
from repro_torch.models import model_zoo, moe
from repro_torch.models import parallel as par
from repro_torch.runtime import elastic
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainState, init_state, loss_and_grads, make_train_step)
from test_torch_train_step import (
    DENSE_KW, MB_ROWS, OCFG, SEQ, STEPS, check_grads, check_metrics,
    check_params, names, np_tree, reference_run, tokens_for)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
MOE = "qwen3-moe-30b-a3b"
MOE_KW = dict(dtype="float32")
CKPT_KW = dict(dtype="bfloat16", n_layers=2, d_model=64, vocab_size=256,
               max_seq_len=64)
FLASH_KW = dict(DENSE_KW, n_layers=1, max_seq_len=4096)
FLASH_SEQ = 3072  # past attention.FLASH_THRESHOLD
LAUNCH_ARGS = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
               "--steps", "3", "--global-batch", "4", "--seq-len", "32",
               "--microbatches", "2", "--checkpoint-every", "100"]
EP_B, EP_S = 4, 16  # capacity(16) = 8 slots an expert for 64+ local pairs


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def refs():
    """The reference's init state, tokens, step-1 gradients and three
    steps at microbatches 2 (global batch 4), for llama and moe."""
    return {"llama2-7b": reference_run("llama2-7b", DENSE_KW, (2,),
                                       jit_steps=(2,)),
            MOE: reference_run(MOE, MOE_KW, (2,), jit_steps=(2,))}


@functools.lru_cache(maxsize=None)
def ref_inputs(arch: str, kw_items: tuple):
    """``reference_run``'s init params (as the port's) and its three
    batches at microbatches 2, without compiling its steps: the ranks
    start on these while the reference compiles."""
    import jax

    from repro.configs import SMOKE as JSMOKE
    from repro.models import model_zoo as jzoo
    from repro.train import optimizer as jopt
    from repro.train.train_step import init_state as j_init_state

    kw = dict(kw_items)
    jcfg = JSMOKE[arch].scaled(**kw)
    state = j_init_state(jzoo.build(jcfg), jax.random.PRNGKey(0),
                         jopt.OptConfig(**OCFG))
    params = train_state_from_jax(np_tree(state), SMOKE[arch].scaled(**kw),
                                  "cpu").params
    tokens = [tokens_for(jcfg.vocab_size, MB_ROWS * 2, SEQ, 20 + i)
              for i in range(STEPS)]
    return params, tokens


def ref_case(name, arch, kw, mesh, remat=True, **more):
    params, tokens = ref_inputs(arch, tuple(sorted(kw.items())))
    return dict(kind="step", name=name, arch=arch, kw=kw, mesh=mesh,
                params=params,
                tokens=[torch.from_numpy(t).long() for t in tokens],
                microbatches=2, remat=remat, ocfg=OCFG, **more)


def flash_case():
    cfg = SMOKE["llama2-7b"].scaled(**FLASH_KW)
    rng = np.random.default_rng(3)
    return dict(kind="step", name="dense_flash_1x2", arch="llama2-7b",
                kw=FLASH_KW, mesh=(1, 2),
                params=model_zoo.build(cfg).init_params(seed=0,
                                                        device="cpu"),
                tokens=[torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (2, FLASH_SEQ))).long()],
                microbatches=1, remat="save_attn", ocfg=OCFG)


@functools.lru_cache(maxsize=None)
def ep_inputs() -> dict:
    """Moe layer weights and tokens (numpy seed 0), the router scaled so
    routing is decisive (every token's top 3 probabilities 1e-4 apart,
    so f32 sums in another order pick the same experts in order)."""
    cfg = SMOKE[MOE].scaled(**MOE_KW)
    rng = np.random.default_rng(0)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff

    def draw(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"router": draw(D, E, scale=0.5), "w_in": draw(E, D, F, scale=D**-.5),
         "w_gate": draw(E, D, F, scale=D**-.5),
         "w_out": draw(E, F, D, scale=F**-.5)}
    x = draw(EP_B, EP_S, D)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        p["router"]), -1)
    top = torch.topk(probs, 3, -1).values
    assert float((top[..., :-1] - top[..., 1:]).min()) > 1e-4
    return {**p, "x": x, "dy": draw(EP_B, EP_S, D)}


def ep_case(mesh):
    t = {k: torch.from_numpy(v) for k, v in ep_inputs().items()}
    return dict(kind="ep", name=f"ep_{mesh[0]}x{mesh[1]}", arch=MOE,
                kw=MOE_KW, mesh=mesh, x=t.pop("x"), dy=t.pop("dy"), p=t)


def ckpt_tokens():
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.integers(0, 256, (4, 32))).long()
            for _ in range(3)]


STEP_CASES = {  # name -> (arch, kw, mesh, remat); against the reference too
    "dense_1x2": ("llama2-7b", DENSE_KW, (1, 2), True),
    "dense_2x1": ("llama2-7b", DENSE_KW, (2, 1), "save_attn"),
    "dense_2x2": ("llama2-7b", DENSE_KW, (2, 2), False),
    "moe_2x1": (MOE, MOE_KW, (2, 1), True),
}
EP_STEP_CASES = {  # the model axis splits the experts: EP semantics
    "moe_1x2": (MOE, MOE_KW, (1, 2), True),
    "moe_2x2": (MOE, MOE_KW, (2, 2), True),
    "moe_1x4": (MOE, MOE_KW, (1, 4), True),  # KV 2 on a model axis of 4
}
EP_MESHES = ((1, 2), (1, 4), (2, 2))


def cases(tmp: pathlib.Path) -> list:
    out = [ref_case(n, *c) for n, c in {**STEP_CASES,
                                        **EP_STEP_CASES}.items()]
    out.append(flash_case())
    out += [ep_case(m) for m in EP_MESHES]
    ck = dict(arch="llama2-7b", kw=CKPT_KW, ocfg=OCFG, tokens=ckpt_tokens(),
              dir=str(tmp / "ckpt"))
    out += [dict(kind="ckpt_save", name="ckpt_save", mesh=(2, 2), **ck),
            dict(kind="ckpt_restore", name="ckpt_restore", mesh=(1, 2),
                 **ck),
            dict(kind="supervise", name="supervise", mesh=(1, 2),
                 dir=str(tmp / "supervise"),
                 args=LAUNCH_ARGS[:5] + ["--steps", "5", "--global-batch",
                                         "4", "--seq-len", "32",
                                         "--checkpoint-every", "2",
                                         "--model-parallel", "2"])]
    return out


EP_REF_SCRIPT = r"""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import SMOKE
from repro.models import moe

inp = np.load(sys.argv[1])
cfg = SMOKE["qwen3-moe-30b-a3b"].scaled(dtype="float32")
p = {k: jnp.asarray(inp[k]) for k in ("router", "w_in", "w_gate", "w_out")}
x = jnp.asarray(inp["x"])
seen = {}


def record(keep, m, d):
    seen[(int(m), int(d))] = np.asarray(keep)


def where(c, *a):
    # _apply_ep's local_fn: sid = jnp.where(keep, slot, C), keep (N*K,)
    if a and jnp.ndim(c) == 1 and jnp.result_type(c) == jnp.bool_:
        jax.debug.callback(record, c, jax.lax.axis_index("model"),
                           jax.lax.axis_index("data"))
    return jnp.where(c, *a)


names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("_")}
names["where"] = where
moe.jnp = types.SimpleNamespace(**names)
out = {}
B, S, K = x.shape[0], x.shape[1], cfg.n_experts_active
for dp, tp in ((1, 2), (1, 4), (2, 2)):
    seen.clear()
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    with mesh:
        y, aux = moe.apply(p, cfg, x)
    jax.effects_barrier()
    assert sorted(seen) == [(m, d) for m in range(tp) for d in range(dp)]
    tag = f"{dp}x{tp}"
    out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
    out["keep_" + tag] = np.stack([np.concatenate([
        seen[(m, d)].reshape(B // dp, S, K) for d in range(dp)])
        for m in range(tp)])
np.savez(sys.argv[2], **out)
print("EP_REF_OK")
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE",
                        "COORDINATOR_ADDRESS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)), **extra)
    return env


def _start(args, env=None) -> subprocess.Popen:
    return subprocess.Popen(args, env=env or _env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs: dict) -> dict:
    outs = {}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        assert proc.returncode == 0, f"{name}:\n{out[-6000:]}"
        outs[name] = out
    return outs


def _torchrun(n: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}", *args]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run, their outputs under ``out``; the
    single-device launcher run in-process beside the last ones."""
    tmp = tmp_path_factory.mktemp("model_axis")
    out = tmp / "out"
    out.mkdir()
    torch.save(cases(tmp), tmp / "cases.pt")
    np.savez(tmp / "ep_in.npz", **ep_inputs())
    worker = [str(ROOT / "tests" / "model_axis_worker.py"),
              str(tmp / "cases.pt"), str(out)]
    ref_env = _env(XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    first = {"world4": _start(_torchrun(4, *worker)),
             "ep_ref": _start([sys.executable, "-c", EP_REF_SCRIPT,
                               str(tmp / "ep_in.npz"),
                               str(out / "ep_ref.npz")], ref_env)}
    refs()  # the reference's steps compile while the ranks run
    logs = _finish(first)
    assert "EP_REF_OK" in logs["ep_ref"]
    # one torchrun group starts at a time: each picks its ports as it
    # starts, and two starting together can be handed the same one
    port = _free_port()
    coord = {f"coord{r}": _start(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
         "--model-parallel", "2", "--ckpt-dir", str(tmp / "coord")],
        _env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", RANK=str(r),
             WORLD_SIZE="2")) for r in range(2)}
    logs.update(_finish({"world2": _start(_torchrun(2, *worker)), **coord}))
    procs = {"torchrun": _start(_torchrun(
        2, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
        "--model-parallel", "2", "--ckpt-dir", str(tmp / "torchrun")))}
    with contextlib.redirect_stdout(io.StringIO()) as single:
        launch_train.main(LAUNCH_ARGS + ["--ckpt-dir", str(tmp / "single")])
    logs.update(_finish(procs), single=single.getvalue())
    return {"out": out, "tmp": tmp, "logs": logs}


def result(runs, name: str):
    return torch.load(runs["out"] / f"{name}.pt", weights_only=False)


def close(got, want, rtol: float = 1e-5, what: str = ""):
    for n, a, b in zip(names(want), opt.tree_leaves(got),
                       opt.tree_leaves(want)):
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=1e-6 * float(b.abs().max()),
            msg=lambda m, n=n: f"{what}{n}: {m}")


@functools.lru_cache(maxsize=None)
def single_device(name: str) -> dict:
    """The port's step on one device from the case's params and tokens;
    for an EP case with ``moe.apply`` as ``_apply_ep_plain`` at the
    mesh's (tp, dp)."""
    case = next(c for c in cases(pathlib.Path("unused")) if c["name"] == name)
    cfg = SMOKE[case["arch"]].scaled(**case["kw"])
    model = model_zoo.build(cfg)
    ocfg = opt.OptConfig(**case["ocfg"])
    mb, remat = case["microbatches"], case["remat"]
    real = moe.apply
    dp, tp = case["mesh"]
    if name in EP_STEP_CASES:
        moe.apply = lambda p, c, x: moe._apply_ep_plain(p, c, x, tp, dp)[:2]
    try:
        params = case["params"]
        grads, m1 = loss_and_grads(model, params,
                                   {"tokens": case["tokens"][0]},
                                   microbatches=mb, remat=remat)
        state = TrainState(params, opt.init(params, ocfg))
        step = make_train_step(model, ocfg, microbatches=mb, remat=remat)
        trace = []
        for t in case["tokens"]:
            state, m = step(state, {"tokens": t})
            trace.append({k: float(v) for k, v in m.items()})
    finally:
        moe.apply = real
    return {"grads": grads, "metrics": {k: float(v) for k, v in m1.items()},
            "trace": trace, "params": state.params, "cfg": cfg}


ALL_STEPS = sorted({**STEP_CASES, **EP_STEP_CASES}) + ["dense_flash_1x2"]


@pytest.mark.parametrize("name", ALL_STEPS)
def test_sharded_step_matches_single_device(runs, name):
    """Step 1's gradients and metrics and three steps' metrics and params
    (one for the flash case) on the mesh, gathered, against the port's
    single-device step."""
    got, want = result(runs, name), single_device(name)
    rtol = {"loss": 1e-6, "nll": 1e-6, "lr": 1e-6, "ppl_proxy": 1e-5,
            "grad_norm": 1e-5}
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=rtol[k],
                                   err_msg=k)
    for i, (g, w) in enumerate(zip(got["trace"], want["trace"])):
        for k in rtol:  # after step 1 the params carry Adam's noise
            np.testing.assert_allclose(g[k], w[k], rtol=max(
                rtol[k], 1e-5 if i else 0), err_msg=f"step {i + 1} {k}")
    close(got["grads"], want["grads"], what="grad ")
    check_params(got["params"], want["params"], OCFG["lr"], want["grads"])


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_step_matches_reference(runs, name):
    """The same runs against the reference's step (its GSPMD semantics:
    no expert split on these meshes) by ``test_torch_train_step``'s
    bars."""
    arch = STEP_CASES[name][0]
    ref, got = refs()[arch], result(runs, name)
    cfg = SMOKE[arch].scaled(**STEP_CASES[name][1])
    _, tokens = ref_inputs(arch, tuple(sorted(STEP_CASES[name][1].items())))
    assert all(np.array_equal(a, b) for a, b in zip(tokens,
                                                    ref["tokens"][2]))
    check_metrics(got["metrics"], ref["metrics"][2])
    check_grads(got["grads"], ref["grads"][2], cfg)
    trace, params = ref["steps"][2]
    for g, w in zip(got["trace"], trace):
        check_metrics(g, {k: w[k] for k in ("loss", "nll", "lr")})
    check_params(got["params"], params_from_jax(params, cfg, "cpu"),
                 OCFG["lr"], params_from_jax(ref["grads"][2], cfg, "cpu",
                                             keep_dtype=True))


@pytest.mark.parametrize("name,flash,ep", [
    ("dense_flash_1x2", 1, 0),   # save_attn: attention once a layer
    ("dense_1x2", 0, 0),
    ("moe_1x2", 0, 2 * 2 * 2),   # layers x microbatches x (fwd + remat)
    ("moe_2x2", 0, 2 * 2 * 2),
    ("moe_1x4", 0, 2 * 2 * 2),
    ("moe_2x1", 0, 0),           # model axis 1: the dense dispatch
])
def test_paths_taken_under_the_mesh(runs, name, flash, ep):
    """The flash path at S = 3072 under a model axis and expert
    parallelism wherever the model axis splits the experts, by their
    counts in the gradient pass."""
    assert result(runs, name)["calls"] == {"flash": flash, "ep": ep}


def test_kv_heads_the_model_axis_does_not_divide(runs):
    """Smoke Qwen3-MoE (4 query heads, 2 KV heads of 16) on a model axis
    of 4: wk / wv columns are split mid-head in storage, read whole, and
    their gradients summed over the model axis (a rank's query head reads
    KV head rank // 2); wq / wo split by heads."""
    modes = result(runs, "moe_1x4")["modes"]
    cfg = SMOKE[MOE].scaled(**MOE_KW)
    got = {n.rsplit(".", 1)[1]: m for n, m in modes.items()
           if n.startswith("layers.0.attn.")}
    assert got == {"wq": par.SPLIT, "wo": par.SPLIT, "wk": par.FULL_SUM,
                   "wv": par.FULL_SUM, "q_norm": par.FULL_SUM,
                   "k_norm": par.FULL_SUM}
    model = model_zoo.build(cfg)
    specs = cm.sanitize_specs(model_zoo.abstract_params(model),
                              model.param_specs(), {"data": 1, "model": 4})
    # 32 columns over 4: half a head a rank
    assert tuple(specs["layers"][0]["attn"]["wk"]) == ("data", "model")


@functools.lru_cache(maxsize=None)
def ep_plain(mesh) -> dict:
    """``_apply_ep_plain`` at the mesh's (tp, dp) and the gradients of
    sum(y * dy) + aux."""
    cfg = SMOKE[MOE].scaled(**MOE_KW)
    t = {k: torch.from_numpy(v) for k, v in ep_inputs().items()}
    x, dy = t.pop("x").requires_grad_(), t.pop("dy")
    p = {k: v.requires_grad_() for k, v in t.items()}
    y, aux, keep = moe._apply_ep_plain(p, cfg, x, mesh[1], mesh[0])
    grads = torch.autograd.grad((y * dy).sum() + aux,
                                [x] + [p[k] for k in sorted(p)])
    return {"y": y.detach(), "aux": aux.detach(), "keep": keep,
            "grads": dict(zip(["x"] + sorted(p), grads))}


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_plain_matches_reference(runs, mesh):
    """``_apply_ep_plain`` against the reference's ``_apply_ep`` under the
    same mesh: each shard's keep mask exactly (pairs dropped), y and aux
    at rtol 1e-5, atol 1e-6."""
    ref = np.load(runs["out"] / "ep_ref.npz")
    tag = f"{mesh[0]}x{mesh[1]}"
    mine = ep_plain(mesh)
    assert np.array_equal(mine["keep"].numpy(), ref["keep_" + tag])
    assert not ref["keep_" + tag].any(0).all()  # the capacity drops pairs
    np.testing.assert_allclose(mine["y"].numpy(), ref["y_" + tag],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(mine["aux"]), float(ref["aux_" + tag]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_ranks_match_plain(runs, mesh):
    """``_apply_ep`` on the mesh's ranks against ``_apply_ep_plain``: the
    keep masks exactly, y, aux and the gradients of x, the router and the
    expert stacks (each data rank's part summed) at rtol 1e-5, atol 1e-6
    * max."""
    dp, tp = mesh
    ranks = result(runs, f"ep_{dp}x{tp}")["ranks"]
    want = ep_plain(mesh)
    at = {(r["data"], r["model"]): r for r in ranks}
    keep = torch.stack([torch.cat([at[(d, m)]["keep"] for d in range(dp)])
                        for m in range(tp)])
    assert torch.equal(keep, want["keep"])
    y = torch.cat([at[(d, 0)]["y"] for d in range(dp)])
    for m in range(tp):
        assert torch.equal(torch.cat([at[(d, m)]["y"] for d in range(dp)]),
                           y)
    got = {"y": y, "aux": at[(0, 0)]["aux"],
           "x": torch.cat([at[(d, 0)]["grads"]["x"] for d in range(dp)]),
           "router": sum(at[(d, 0)]["grads"]["router"] for d in range(dp))}
    for k in ("w_in", "w_gate", "w_out"):
        got[k] = torch.cat([sum(at[(d, m)]["grads"][k] for d in range(dp))
                            for m in range(tp)])
    w = dict(want["grads"], y=want["y"], aux=want["aux"])
    for k, g in got.items():
        torch.testing.assert_close(g, w[k], rtol=1e-5,
                                   atol=1e-6 * float(w[k].abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")


# ---------------------------------------------------------------------------
# checkpoints, supervise, the launcher
# ---------------------------------------------------------------------------

def _bitwise(a, b) -> bool:
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _state_leaves(state: TrainState) -> list:
    return opt.tree_leaves(state.params) + [state.opt.step] + [
        x for t in (state.opt.m, state.opt.v, state.opt.master)
        for x in opt.tree_leaves(t)]


@pytest.mark.parametrize("how", ["shardings", "reshard"])
def test_checkpoint_from_2x2_restores_at_world_2(runs, how):
    """A bf16 train state saved from a (2, 2) mesh (whole arrays) restores
    on a (1, 2) mesh through ``restore(shardings=)`` and through a whole
    restore then ``elastic.reshard``: every leaf bit for bit, placed as
    the mesh's own state. On the (2, 2) mesh, step 3 from the restore is
    bit for bit the uninterrupted run's step 3."""
    saved = result(runs, "ckpt_save")
    got = result(runs, "ckpt_restore")
    assert got["meta"] == {"mesh": [2, 2]} and got["placed"]
    a, b = _state_leaves(got[how]), _state_leaves(saved["state"])
    assert len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert any(x.dtype == torch.bfloat16 for x in a)
    assert _bitwise(saved["step3_restored"], saved["step3"])


@pytest.fixture(scope="module")
def host_mesh():
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("how", ["shardings", "reshard"])
def test_checkpoint_from_2x2_restores_at_world_1(runs, host_mesh, how):
    """The same checkpoint at world 1 (a 1 x 1 mesh in this process):
    DTensor leaves, bit for bit."""
    saved = result(runs, "ckpt_save")
    cfg = SMOKE["llama2-7b"].scaled(**CKPT_KW)
    model = model_zoo.build(cfg)
    ocfg = opt.OptConfig(**OCFG)
    ckpt = Checkpointer(str(runs["tmp"] / "ckpt"))
    if how == "shardings":
        like = init_state(model, 0, ocfg, device="cpu", mesh=host_mesh)
        got, _ = ckpt.restore(like, step=2, shardings=launch_train
                              .shardings_for(host_mesh, model, like))
    else:
        whole, _ = ckpt.restore(init_state(model, 0, ocfg, device="cpu"),
                                step=2)
        pspecs = model.param_specs()
        got = elastic.reshard(whole, TrainState(
            pspecs, opt.state_specs(pspecs)), host_mesh)
    leaves = _state_leaves(got)
    assert all(hasattr(x, "full_tensor") for x in leaves)
    a = [x.full_tensor() for x in leaves]
    b = _state_leaves(saved["state"])
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))


def test_supervise_restart_restores_on_both_ranks(runs):
    """``launch.train.run`` at --model-parallel 2 on 2 ranks with a failure
    injected before step 3: both ranks restart once from the step-2
    checkpoint and end bit for bit where the run without the failure
    ends."""
    got = result(runs, "supervise")
    assert got["failed"]["ranks"] == [(5, 1), (5, 1)]
    assert got["clean"]["ranks"] == [(5, 0), (5, 0)]
    assert _bitwise(_state_leaves(got["failed"]["state"]),
                    _state_leaves(got["clean"]["state"]))


def _step0_loss(log: str) -> str:
    return next(line.split("loss=")[1].split()[0]
                for line in log.splitlines() if line.startswith("step 0:"))


@pytest.mark.parametrize("start", ["torchrun", "coord0"])
def test_launcher_model_parallel_matches_single_device(runs, start):
    """``launch.train --model-parallel 2`` on 2 ranks, started by torchrun
    and by ``COORDINATOR_ADDRESS`` (RANK and WORLD_SIZE per process): rank
    0 prints the single-device run's step-0 loss and the mesh, the other
    rank nothing, and the final checkpoint (whole arrays) holds the
    single-device run's params by ``check_params``."""
    log = runs["logs"][start]
    single = Checkpointer(str(runs["tmp"] / "single"))
    assert "mesh={'data': 1, 'model': 2}" in log
    if start == "coord0":
        assert "step 0" not in runs["logs"]["coord1"]
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    like = init_state(model, 0, opt.OptConfig(**OCFG), device="cpu")
    want, _ = single.restore(like, step=3)
    got, _ = Checkpointer(str(runs["tmp"] / (
        "torchrun" if start == "torchrun" else "coord"))).restore(like,
                                                                  step=3)
    check_params(got.params, want.params, float(
        launch_train.parse_args(LAUNCH_ARGS).lr), want.params)
    assert int(got.opt.step) == 3
    assert _step0_loss(log) == _step0_loss(runs["logs"]["single"])
