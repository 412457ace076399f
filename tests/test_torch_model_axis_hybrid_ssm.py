"""The mesh's model axis for the hybrid (Zamba2: the shared block on the
rank's heads, each group's LoRA densify giving its columns, each Mamba2
mixer on its heads) and ssm (xLSTM: mLSTM and sLSTM blocks on the rank's
heads, the sLSTM FFN on its hidden units) families: their smoke configs
on one ``torchrun`` group of 2 gloo CPU ranks (``ranks.py``,
``model_axis_worker.py``) at meshes (1, 2) and (2, 1), against the port's
single device and the reference's step; the hybrid once more at 3,072
positions through ``FlashAttentionFn`` on the rank's heads. In the same
group a bf16 hybrid train state is saved from (1, 2) and restored at
(2, 1); this process restores it at world 1. ``launch.train
--model-parallel 2 --arch zamba2-7b`` runs on its own group of 2 beside
them and is held to the single-device launcher. Cases, bars and inputs:
``model_axis_families.py``.
"""
import contextlib
import functools
import io

import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SMOKE
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo
from repro_torch.models import parallel as par
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import init_state

import model_axis_families as maf
from test_torch_model_axis import _bitwise, _state_leaves, _step0_loss
from test_torch_train_step import OCFG, check_params

HYBRID = "zamba2-7b"
FLASH_KW = dict(maf.KW, n_layers=2, max_seq_len=4096)  # one group
CKPT_KW = dict(dtype="bfloat16")
CASES = {  # name -> a function making the case
    "hybrid_1x2": lambda: maf.step_case("hybrid", (1, 2), True),
    "hybrid_2x1": lambda: maf.step_case("hybrid", (2, 1), False),
    "hybrid_flash_1x2": lambda: maf.flash_case("hybrid", FLASH_KW, True),
    "ssm_1x2": lambda: maf.step_case("ssm", (1, 2), True),
    "ssm_2x1": lambda: maf.step_case("ssm", (2, 1), False),
}
LAUNCH_ARGS = ["--arch", HYBRID, "--smoke", "--device", "cpu", "--steps",
               "3", "--global-batch", "4", "--seq-len", "32",
               "--microbatches", "2", "--checkpoint-every", "100"]


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


def ckpt_cases(tmp) -> list:
    ck = dict(arch=HYBRID, kw=CKPT_KW, ocfg=OCFG,
              tokens=[torch.randint(0, 512, (4, 32),
                                    generator=torch.Generator().manual_seed(
                                        5 + i)) for i in range(3)],
              dir=str(tmp / "ckpt"))
    return [dict(kind="ckpt_save", name="ckpt_save", mesh=(1, 2), **ck),
            dict(kind="ckpt_restore", name="ckpt_restore", mesh=(2, 1),
                 **ck)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The step and checkpoint cases on one group of 2 ranks, the
    launcher on another; the reference's steps compile and the
    single-device launcher runs while they do."""
    tmp = tmp_path_factory.mktemp("model_axis_hybrid_ssm")
    procs = {"world2": maf.start_worker(
        tmp, [case(n) for n in CASES] + ckpt_cases(tmp)),
             "torchrun": maf.ranks.start(maf.ranks.torchrun(
                 2, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
                 "--model-parallel", "2", "--ckpt-dir", tmp / "torchrun"))}
    for family in ("hybrid", "ssm"):
        maf.reference(family)
    for name in CASES:
        single(name)
    with contextlib.redirect_stdout(io.StringIO()) as one:
        launch_train.main(LAUNCH_ARGS + ["--ckpt-dir", str(tmp / "single")])
    logs = maf.ranks.finish(procs)
    return {"tmp": tmp, "logs": dict(logs, single=one.getvalue())}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_single_device(runs, name):
    c = case(name)
    maf.check_single_device(maf.result(runs["tmp"], name),
                            single(name), name.split("_")[0],
                            c["ocfg"]["lr"])


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_sharded_step_matches_reference(runs, family):
    maf.check_reference(maf.result(runs["tmp"], f"{family}_1x2"), family)


@pytest.mark.parametrize("name,flash", [
    ("hybrid_flash_1x2", 2),  # one group, remat: its forward twice
    ("hybrid_1x2", 0), ("ssm_1x2", 0)])
def test_flash_calls_under_the_mesh(runs, name, flash):
    """The shared block's flash path at 3,072 positions on the rank's 2
    heads, by its count in the gradient pass (remat: the group's forward
    twice); none at 32 tokens."""
    assert maf.result(runs["tmp"], name)["calls"] == {"flash": flash,
                                                       "ep": 0}


def test_hybrid_reads_packed_leaves_whole(runs):
    """At (1, 2) smoke Zamba2's 8 Mamba heads split 4 a rank: ``in_proj``
    ([z | x | B | C | dt]) and the conv ([x | B | C]) are read whole, as
    are the per-head scan leaves, their gradients summed over the model
    axis; ``norm_scale`` and ``out_proj``'s rows are the rank's heads'.
    The LoRA B factors are read as the weights they are added to, A
    whole."""
    modes = maf.result(runs["tmp"], "hybrid_1x2")["modes"]
    mixer = {n.rsplit(".", 1)[1]: m for n, m in modes.items()
             if n.startswith("mamba.1.0.mixer.")}
    assert mixer == {"in_proj": par.FULL_SUM, "conv_w": par.FULL_SUM,
                     "conv_b": par.FULL_SUM, "A_log": par.FULL_SUM,
                     "dt_bias": par.FULL_SUM, "D_skip": par.FULL_SUM,
                     "norm_scale": par.SPLIT, "out_proj": par.SPLIT}
    assert {n: modes[n] for n in modes if n.startswith("lora.")} == {
        f"lora.{x}.{f}": par.FULL_SUM if f == "A" else par.SPLIT
        for x in "qkv" for f in "AB"}
    assert modes["shared.attn.wq"] == par.SPLIT
    assert modes["embed"] == modes["lm_head"] == par.SPLIT


def test_ssm_reads_its_heads(runs):
    """At (1, 2) smoke xLSTM's 2 heads split 1 a rank: the mLSTM reads
    its heads' columns of ``up_gate``, q/k/v and ``w_o`` and ``down``'s
    rows, ``up`` and the gates' weights whole; the sLSTM its heads' gate
    columns, biases and recurrences, and its FFN's hidden units."""
    modes = maf.result(runs["tmp"], "ssm_1x2")["modes"]
    ml = {n.rsplit(".", 1)[1]: m for n, m in modes.items()
          if n.startswith("layers.0.core.")}
    assert {k for k, m in ml.items() if m == par.SPLIT} == {
        "up_gate", "wq", "wk", "wv", "w_o", "down"}
    assert {k for k, m in ml.items() if m == par.FULL_SUM} == {
        "up", "w_i", "w_f", "b_i", "b_f"}
    sl = {n.split("layers.1.core.", 1)[1]: m for n, m in modes.items()
          if n.startswith("layers.1.core.")}
    assert {k for k, m in sl.items() if m != par.SPLIT} == {"ffn_norm"}


@pytest.mark.parametrize("how", ["shardings", "reshard"])
def test_hybrid_checkpoint_from_1x2_restores_at_world_2(runs, how):
    """A bf16 hybrid train state (the trunk a list of groups of Mamba
    layers, the LoRA factors stacked) saved from (1, 2) restores on a
    (2, 1) mesh through ``restore(shardings=)`` and through a whole
    restore then ``elastic.reshard``: every leaf bit for bit; on (1, 2)
    step 3 from the restore is bit for bit the uninterrupted run's."""
    saved = maf.result(runs["tmp"], "ckpt_save")
    got = maf.result(runs["tmp"], "ckpt_restore")
    assert got["meta"] == {"mesh": [1, 2]} and got["placed"]
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


def test_hybrid_checkpoint_from_1x2_restores_at_world_1(runs, host_mesh):
    """The same checkpoint at world 1 (a 1 x 1 mesh in this process):
    DTensor leaves, bit for bit."""
    saved = maf.result(runs["tmp"], "ckpt_save")
    model = model_zoo.build(SMOKE[HYBRID].scaled(**CKPT_KW))
    like = init_state(model, 0, opt.OptConfig(**OCFG), device="cpu",
                      mesh=host_mesh)
    got, _ = Checkpointer(str(runs["tmp"] / "ckpt")).restore(
        like, step=2, shardings=launch_train.shardings_for(host_mesh, model,
                                                           like))
    a = [x.full_tensor() for x in _state_leaves(got)]
    b = _state_leaves(saved["state"])
    assert len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_launcher_model_parallel_hybrid_matches_single_device(runs):
    """``launch.train --model-parallel 2 --arch zamba2-7b`` on 2 ranks
    under torchrun: rank 0 prints the single-device run's step-0 loss and
    the mesh, and the final checkpoint (whole arrays) holds the
    single-device run's params by ``check_params``."""
    log = runs["logs"]["torchrun"]
    assert "mesh={'data': 1, 'model': 2}" in log
    assert _step0_loss(log) == _step0_loss(runs["logs"]["single"])
    model = model_zoo.build(SMOKE[HYBRID].scaled(dtype="float32"))
    like = init_state(model, 0, opt.OptConfig(**OCFG), device="cpu")
    want, _ = Checkpointer(str(runs["tmp"] / "single")).restore(like, step=3)
    got, _ = Checkpointer(str(runs["tmp"] / "torchrun")).restore(like,
                                                                 step=3)
    check_params(got.params, want.params, float(
        launch_train.parse_args(LAUNCH_ARGS).lr), want.params)
    assert int(got.opt.step) == 3
