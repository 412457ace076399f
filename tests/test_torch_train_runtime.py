"""The port's training runtime on the CPU: supervision with checkpoint and
restart (``runtime/fault_tolerance``), straggler detection
(``runtime/straggler``), the resumable ``SyntheticStream``, a
``TrainState`` through the ``Checkpointer`` (and from the reference,
``convert.train_state_from_jax``), the launcher ``launch/train`` with a
resumed second run and an injected failure, and the reference's
``tests/test_system.py`` (train -> quantize -> serve) inside the port;
mirrors of the reference's ``TestFaultTolerance`` and ``TestStraggler``.
"""
import json
import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.train import optimizer as jopt
from repro.train.train_step import init_state as j_init_state
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SMOKE
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainState, init_state

SMOKE_ARGS = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
              "--global-batch", "4", "--seq-len", "16",
              "--checkpoint-every", "2"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def leaves(state):
    return (opt.tree_leaves(state.params) + opt.tree_leaves(state.opt.m)
            + opt.tree_leaves(state.opt.v)
            + opt.tree_leaves(state.opt.master) + [state.opt.step])


def same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# mirrors of the reference's TestFaultTolerance and TestStraggler
# ---------------------------------------------------------------------------

def test_restart_from_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    fails = {"n": 0}

    def step_fn(state, step):
        if step == 7 and fails["n"] == 0:
            fails["n"] += 1
            raise RuntimeError("simulated device failure")
        return {"v": state["v"] + 1}

    res = ft.supervise(
        state={"v": torch.zeros(())}, step_fn=step_fn, ckpt=ck,
        total_steps=10, checkpoint_every=2, max_restarts=2,
        heartbeat_path=str(tmp_path / "hb.json"))
    assert res.restarts == 1
    assert res.steps_done == 10
    assert float(res.final_state["v"]) == 10.0
    assert os.path.exists(tmp_path / "hb.json")
    assert json.load(open(tmp_path / "hb.json"))["step"] == 10


def test_restart_waits_for_the_async_save(tmp_path, monkeypatch):
    """A failure while the async save of the step before is still being
    written restores that step, not nothing."""
    from repro_torch.checkpoint import checkpointer as ck_mod

    write = ck_mod._write

    def slow_write(*a):
        time.sleep(0.2)
        write(*a)

    monkeypatch.setattr(ck_mod, "_write", slow_write)
    ck = Checkpointer(str(tmp_path), keep=5, async_save=True)
    fails = []

    def step_fn(state, step):
        if step == 3 and not fails:
            fails.append(step)
            raise RuntimeError("simulated device failure")
        return {"v": state["v"] + 1}

    res = ft.supervise(state={"v": torch.zeros(())}, step_fn=step_fn,
                       ckpt=ck, total_steps=4, checkpoint_every=2)
    assert (res.restarts, res.steps_done) == (1, 4)
    assert float(res.final_state["v"]) == 4.0


def test_too_many_restarts_raise(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)

    def step_fn(state, step):
        if step == 3:
            raise RuntimeError("simulated device failure")
        return {"v": state["v"] + 1}

    with pytest.raises(RuntimeError, match="simulated"):
        ft.supervise(state={"v": torch.zeros(())}, step_fn=step_fn, ckpt=ck,
                     total_steps=6, checkpoint_every=2, max_restarts=2)


def test_flags_outliers():
    mon = StragglerMonitor(window=16, k_mad=4.0, min_samples=4)
    for i in range(10):
        mon.record(i, 1.0 + 0.01 * (i % 3), host=i % 4)
    rep = mon.record(10, 5.0, host=2)
    assert rep.is_straggler
    for i in range(3):
        mon.record(11 + i, 6.0, host=2)
    assert 2 in mon.quarantine_candidates(repeat_threshold=3)


# ---------------------------------------------------------------------------
# the stream, the state on disk, the state from the reference
# ---------------------------------------------------------------------------

def test_synthetic_stream_resumes_its_batches():
    a = SyntheticStream(64, seq_len=8, global_batch=4, seed=3)
    batches = [a.next() for _ in range(4)]
    b = SyntheticStream(64, seq_len=8, global_batch=4, seed=3)
    b.restore(dict(a.state(), step=2))
    assert torch.equal(b.next(), batches[2])
    assert torch.equal(b.next(), batches[3])
    assert a.state() == {"step": 4, "seed": 3}
    shards = [SyntheticStream(64, 8, 4, seed=3, shard_id=i, n_shards=2)
              for i in range(2)]
    s0, s1 = (s.next() for s in shards)
    assert s0.shape == (2, 8) and not torch.equal(s0, s1)
    assert int(batches[0].max()) < 64 and batches[0].dtype == torch.int64


def test_train_state_round_trips_through_the_checkpointer(tmp_path):
    cfg = SMOKE["llama2-7b"].scaled(dtype="bfloat16", n_layers=2)
    model = model_zoo.build(cfg)
    state = init_state(model, 0, opt.OptConfig(moment_dtype="bfloat16"),
                       device="cpu")
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(7, dtype=torch.int32)))
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state)
    names = {e["name"] for e in json.load(open(
        tmp_path / "step_0000000007" / "manifest.json"))["leaves"]}
    assert ".opt.step" in names and ".params__embed__" in names
    assert ".opt.master__layers___1___attn____wq__" in names
    like = init_state(model, 1, opt.OptConfig(moment_dtype="bfloat16"),
                      device="cpu")
    restored, _ = ck.restore(like)
    assert isinstance(restored, TrainState)
    assert same(restored, state)


def test_train_state_from_the_reference():
    """The reference's init state (stacked layers, f32 master, bf16
    moments) converts leaf for leaf."""
    cfg = JSMOKE["llama2-7b"].scaled(dtype="bfloat16", n_layers=2)
    ocfg = jopt.OptConfig(moment_dtype="bfloat16")
    js = j_init_state(jzoo.build(cfg), jax.random.PRNGKey(0), ocfg)
    js = js._replace(opt=js.opt._replace(step=js.opt.step + 3))
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), cfg, "cpu")
    assert int(ts.opt.step) == 3 and ts.opt.step.dtype == torch.int32
    assert len(ts.params["layers"]) == 2
    wq = ts.params["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert ts.opt.master["layers"][1]["attn"]["wq"].dtype == torch.float32
    assert ts.opt.m["layers"][0]["norm1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ts.opt.master["layers"][1]["attn"]["wq"].numpy(),
        np.asarray(js.opt.master["layers"]["attn"]["wq"][1]))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_and_a_second_run_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    res = launch_train.main(SMOKE_ARGS + ["--steps", "4", "--ckpt-dir", ck])
    assert (res.steps_done, res.restarts) == (4, 0)
    assert "device=cpu" in capsys.readouterr().out
    assert Checkpointer(ck).all_steps() == [2, 4]
    res2 = launch_train.main(SMOKE_ARGS + ["--steps", "6", "--ckpt-dir", ck])
    assert res2.steps_done == 6 and int(res2.final_state.opt.step) == 6
    assert json.load(open(os.path.join(ck, "heartbeat.json")))["step"] == 6


def test_launcher_cuts_depth_and_reports_the_split(tmp_path, capsys):
    """``--n-layers`` cuts the config's depth; the last line gives the
    median draw and step seconds."""
    res = launch_train.main(SMOKE_ARGS + [
        "--steps", "2", "--n-layers", "1", "--ckpt-dir", str(tmp_path)])
    assert SMOKE["llama2-7b"].n_layers == 2
    assert len(res.final_state.params["layers"]) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.search(r"median draw [0-9.]+s step [0-9.]+s$", last), last


def test_launcher_resumes_from_an_injected_failure_to_the_same_state(
        tmp_path):
    """A failure at step 3 restores step 2's checkpoint and the stream's
    position: the run ends at the same step with the same state as one
    without the failure."""
    args = launch_train.parse_args(SMOKE_ARGS + [
        "--steps", "5", "--microbatches", "2",
        "--ckpt-dir", str(tmp_path / "clean")])
    clean = launch_train.run(args)
    fails = []

    def fail_once(i):
        if i == 3 and not fails:
            fails.append(i)
            raise RuntimeError("injected failure")

    args.ckpt_dir = str(tmp_path / "failed")
    res = launch_train.run(args, before_step=fail_once)
    assert (res.steps_done, res.restarts) == (5, 1)
    assert same(res.final_state, clean.final_state)


def test_launcher_model_parallel_needs_that_many_ranks(tmp_path):
    """``--model-parallel 2`` in a world of one rank: the mesh plan
    refuses (the model axis is fixed; nothing falls back)."""
    import torch.distributed as dist

    try:
        with pytest.raises(ValueError, match="model_parallel 2"):
            launch_train.main(SMOKE_ARGS + ["--model-parallel", "2",
                                            "--ckpt-dir", str(tmp_path)])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_launcher_coordinator_address_world_of_one(monkeypatch, tmp_path):
    """``COORDINATOR_ADDRESS`` with RANK 0 and WORLD_SIZE 1 starts the
    process group over tcp and trains on a 1 x 1 mesh: the state, gathered,
    is the single-device run's bit for bit (one rank's arithmetic is the
    same), and its checkpoint holds the same whole arrays."""
    import torch.distributed as dist

    from ranks import free_port

    args = SMOKE_ARGS + ["--steps", "3", "--microbatches", "2"]
    clean = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        res = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "mesh")])
        assert dist.get_backend() == "gloo"
        got = [x.full_tensor() for x in leaves(res.final_state)]
        want = leaves(clean.final_state)
        assert len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()
    like = init_state(model_zoo.build(SMOKE["llama2-7b"].scaled(
        dtype="float32")), 0, opt.OptConfig(), device="cpu")
    a, _ = Checkpointer(str(tmp_path / "mesh")).restore(like, step=3)
    b, _ = Checkpointer(str(tmp_path / "one")).restore(like, step=3)
    assert same(a, b)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-small"])
def test_hybrid_and_audio_remat_gradients_equal_plain(arch):
    """The hybrid and audio forwards train under ``remat=``: a
    checkpointed hybrid group, checkpointed audio encoder and decoder
    layers. Their gradients (LoRA B and the q/k/v biases drawn non-zero,
    numpy seed 0: at the reference's zeros a wrong slice goes unseen)
    agree with ``remat=False``'s to 1e-6 relative Frobenius a leaf, and
    an evaluation under ``no_grad`` ignores ``remat``."""
    from repro_torch.core import adapters
    from repro_torch.train.train_step import loss_and_grads

    cfg = SMOKE[arch].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    rng = np.random.default_rng(0)

    def draw(t):
        return torch.from_numpy(
            (rng.standard_normal(tuple(t.shape)) * 0.02).astype(np.float32))

    if cfg.family == "hybrid":
        for f in params["lora"].values():
            f["B"] = draw(f["B"])
    else:
        for lp in params["enc_layers"] + params["dec_layers"]:
            for attn in (v for k, v in lp.items() if "attn" in k):
                for b in ("bq", "bk", "bv"):
                    attn[b] = draw(attn[b])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
    batch = {"tokens": toks, **adapters.calib_extras(cfg, toks)}
    g_remat, m_remat = loss_and_grads(model, params, batch, microbatches=2,
                                      remat=True)
    g_plain, m_plain = loss_and_grads(model, params, batch, microbatches=2,
                                      remat=False)
    assert float(m_remat["loss"]) == float(m_plain["loss"])
    for a, b in zip(opt.tree_leaves(g_remat), opt.tree_leaves(g_plain)):
        assert float((a - b).norm()) <= 1e-6 * float(b.norm())
    with torch.no_grad():
        logits, _, _ = model.forward(params, batch, remat=True)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the reference's tests/test_system.py, inside the port
# ---------------------------------------------------------------------------

def test_train_quantize_serve_end_to_end():
    from repro_torch.core.bpv import VQConfig
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train.loss import perplexity
    from repro_torch.train.train_step import make_train_step

    cfg = ModelConfig(
        name="e2e", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
        max_seq_len=128, dtype="float32", vocab_pad_multiple=64)
    model = model_zoo.build(cfg)

    # train
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    state = init_state(model, 0, ocfg, device="cpu")
    step = make_train_step(model, ocfg, microbatches=2)
    stream = SyntheticStream(cfg.vocab_size, seq_len=32, global_batch=8)
    first = last = None
    for i in range(40):
        state, metrics = step(state, {"tokens": stream.next()})
        if i == 0:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
    assert last < first

    # quantize (paper's 2D setting) into the packed serving format
    calib = calibration_tokens(cfg.vocab_size, 8, 32, seed=9, device="cpu")
    vq_cfg = VQConfig(d=2, bits_per_dim=3, group_size=4096, em_iters=10,
                      codebook_update_iters=5)
    qparams, report = quantize_model(model, state.params, calib, "gptvq",
                                     vq_cfg, pack=True)
    assert abs(report.bits_per_value - vq_cfg.bits_per_value) < 1e-9

    heldout = calibration_tokens(cfg.vocab_size, 8, 64, seed=4, device="cpu")
    ppl_fp = perplexity(model, state.params, heldout)
    ppl_vq = perplexity(model, qparams, heldout)
    assert np.isfinite(ppl_vq) and ppl_vq < ppl_fp * 2.0, (ppl_fp, ppl_vq)

    # serve batched requests with the quantized weights
    rng = np.random.RandomState(0)
    eng = Engine(model, qparams, max_batch=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=rng.randint(0, 255, size=6),
                    max_new_tokens=4) for i in range(3)]
    out = eng.run(reqs)
    assert all(len(r.out_tokens) >= 4 for r in out)
