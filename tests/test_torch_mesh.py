"""The port's ``data`` mesh axis on the CPU: ``hessian.accumulate_sharded``
over a ``torch.distributed`` ``DeviceMesh`` (gloo), the adapters'
``hessian_mesh`` context through ``quantize_model(hessian_mesh=)``, the
meshes of ``launch/mesh.py`` and the planning of ``runtime/elastic.py``;
mirrors of the reference's ``TestMeshAccumulation`` and ``TestElastic``.

World 1 runs inline on an in-process store (``launch.mesh.make_host_mesh``);
worlds 2 and 4 are ``torchrun`` process groups of CPU ranks, started once
each (``MESH_SCRIPT``), with a time limit.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import hessian as jhes
from repro.runtime import elastic as jelastic
from repro_torch.configs import SMOKE
from repro_torch.core import hessian as hes
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.data.calibration import calibration_tokens
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo
from repro_torch.runtime import elastic

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS, COLS = 21, 96  # 21 rows: zero-padded at 2 and at 4 ranks
QUANT_KW = dict(dtype="float32", n_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def host_mesh():
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def activations(seed: int) -> np.ndarray:
    """Two calls' activations, (2, ROWS, COLS) f32: the second lands on a
    running sum."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, ROWS, COLS)).astype(np.float32)


def reference_sums(xs: np.ndarray):
    st, sd = jhes.init_hessian(COLS), jhes.init_diag_hessian(COLS)
    for x in xs:
        st, sd = jhes.accumulate(st, x), jhes.accumulate_diag(sd, x)
    return st, sd


def sharded_sums(xs: np.ndarray, mesh):
    st, sd = hes.init_hessian(COLS), hes.init_diag_hessian(COLS)
    for x in xs:
        t = torch.from_numpy(x)
        st = hes.accumulate_sharded(st, t, mesh)
        sd = hes.accumulate_sharded(sd, t, mesh)
    return st, sd


def test_sharded_single_device_mesh_inline(host_mesh):
    """World 1: the sharded sum against the reference's ``finalize`` at
    rtol 1e-5 (as the reference's test), and bitwise the port's own
    ``accumulate`` and ``accumulate_diag`` (one rank's arithmetic is
    theirs)."""
    xs = activations(0)
    st, sd = sharded_sums(xs, host_mesh)
    jst, jsd = reference_sums(xs)
    assert st.n == sd.n == 2 * ROWS
    np.testing.assert_allclose(hes.finalize(st).numpy(),
                               np.asarray(jhes.finalize(jst)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hes.finalize_diag(sd).numpy(),
                               np.asarray(jhes.finalize_diag(jsd)),
                               rtol=1e-5)
    pst, psd = hes.init_hessian(COLS), hes.init_diag_hessian(COLS)
    for x in xs:
        pst = hes.accumulate(pst, torch.from_numpy(x))
        psd = hes.accumulate_diag(psd, torch.from_numpy(x))
    assert torch.equal(st.H, pst.H) and torch.equal(sd.diag, psd.diag)


def test_host_mesh_axes(host_mesh):
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)
    plan = elastic.plan_mesh(1, model_parallel=1, pods=1)
    assert elastic.build_mesh(plan, "cpu").mesh_dim_names == ("data",
                                                              "model")


@pytest.mark.parametrize("env, world, cards, want", [
    ({"LOCAL_WORLD_SIZE": "8"}, 16, 8, "nccl"),   # 2 hosts x 8 cards
    ({"LOCAL_WORLD_SIZE": "2"}, 2, 1, "gloo"),    # 2 ranks share a card
    ({}, 1, 1, "nccl"),                           # one process, one card
    ({}, 2, 1, "gloo"),                           # no torchrun: one host
    ({"LOCAL_WORLD_SIZE": "4"}, 4, 8, "nccl"),
])
def test_world_backend_counts_the_ranks_on_this_host(monkeypatch, env,
                                                      world, cards, want):
    """NCCL when each rank on this host has a card of its own, whatever
    the whole world's size; gloo on the CPU at any count."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh_lib.world_backend("cuda", world) == want
    assert mesh_lib.world_backend("cpu", world) == "gloo"


COORDINATOR_CASES = {  # name -> (env, cards, backend, card); None: raises
    # 2 hosts x 8 cards, the launcher names each rank's place on its host
    "two_hosts_local_set": (dict(RANK="11", WORLD_SIZE="16", LOCAL_RANK="3",
                                 LOCAL_WORLD_SIZE="8"), 8, "nccl", 3),
    # 2 hosts x 8 cards, RANK and WORLD_SIZE only: which ranks share a
    # host is unknown
    "two_hosts_rank_only": (dict(RANK="11", WORLD_SIZE="16"), 8, None, None),
    # a world no larger than the cards: RANK is the card
    "world_within_cards": (dict(RANK="5", WORLD_SIZE="8"), 8, "nccl", 5),
    # 2 ranks share one card: gloo, the current card kept
    "ranks_share_a_card": (dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                                LOCAL_WORLD_SIZE="2"), 1, "gloo", None),
    "share_rank_only": (dict(RANK="1", WORLD_SIZE="2"), 1, None, None),
}


@pytest.mark.parametrize("name", sorted(COORDINATOR_CASES))
def test_coordinator_start_picks_backend_and_card(monkeypatch, name):
    """A ``COORDINATOR_ADDRESS`` start (RANK and WORLD_SIZE, LOCAL_RANK
    and LOCAL_WORLD_SIZE where the launcher sets them): NCCL with each
    rank on its own card of its host, gloo when ranks share a card, and
    an error, not a silent choice, when the ranks on this host cannot be
    known; the CPU takes gloo at any count."""
    env, cards, backend, card = COORDINATOR_CASES[name]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:29500")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    world = int(env["WORLD_SIZE"])
    assert mesh_lib.world_backend("cpu", world) == "gloo"
    if backend is None:
        with pytest.raises(ValueError, match="LOCAL_RANK and"):
            mesh_lib.world_backend("cuda", world)
        return
    assert mesh_lib.world_backend("cuda", world) == backend
    chosen, started = [], []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: started.append((a, kw)))
    mesh_lib.init_world(backend)
    assert chosen == ([] if card is None else [card])
    assert started == [((backend,), dict(
        init_method="tcp://10.0.0.1:29500", rank=int(env["RANK"]),
        world_size=world))]


MESH_SCRIPT = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import SMOKE
from repro_torch.core import hessian as hes
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.data.calibration import calibration_tokens
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo

torch.set_num_threads(1)
mode, out = sys.argv[1], sys.argv[2]
mesh = mesh_lib.make_production_mesh(device_type="cpu")
rank = dist.get_rank()
assert mesh.mesh_dim_names == ("data", "model")
assert tuple(mesh.shape) == (dist.get_world_size(), 1)
if mode == "accumulate":
    xs = np.load(sys.argv[3])
    st = hes.init_hessian(xs.shape[-1])
    sd = hes.init_diag_hessian(xs.shape[-1])
    for x in xs:
        st = hes.accumulate_sharded(st, torch.from_numpy(x), mesh)
        sd = hes.accumulate_sharded(sd, torch.from_numpy(x), mesh)
    np.savez(f"{out}/rank{rank}.npz", H=st.H.numpy(), n=st.n,
             diag=sd.diag.numpy(), nd=sd.n)
else:
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=1)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    calib = calibration_tokens(cfg.vocab_size, 8, 32, device="cpu")
    recipe = QuantRecipe.uniform(PAPER_SETTINGS["2.25bpv_2d"]
                                 ).with_quantize_overrides(
        em_iters=4, codebook_update_iters=2)
    q, rep = quantize_model(model, params, calib, recipe=recipe,
                            hessian_mesh=mesh, pack=True)
    torch.save({"params": q, "bpv": rep.achieved_bpv, "errors": {
                    k: v["error"] for k, v in rep.per_target.items()}},
               f"{out}/rank{rank}.pt")
dist.destroy_process_group()
"""


def run_ranks(tmp_path, n: int, *args) -> None:
    """``MESH_SCRIPT`` under ``torchrun --standalone`` on ``n`` CPU ranks."""
    script = tmp_path / "mesh_script.py"
    script.write_text(MESH_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", str(script), *args],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_single_device(tmp_path, world):
    """Worlds 2 and 4 (21 rows: 1 and 3 zero rows padded): every rank
    holds the same sums, ``n`` counts the true rows, and the full and
    diagonal sums agree with the reference's single-device ``accumulate``
    to < 1e-4 (the reference's bar; the sum's order differs)."""
    xs = activations(1)
    np.save(tmp_path / "xs.npy", xs)
    run_ranks(tmp_path, world, "accumulate", str(tmp_path),
              str(tmp_path / "xs.npy"))
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    jst, jsd = reference_sums(xs)
    for g in got:
        assert int(g["n"]) == int(g["nd"]) == 2 * ROWS
        assert np.array_equal(g["H"], got[0]["H"])
        assert np.array_equal(g["diag"], got[0]["diag"])
    assert np.abs(got[0]["H"] - np.asarray(jst.H)).max() < 1e-4
    assert np.abs(got[0]["diag"] - np.asarray(jsd.diag)).max() < 1e-4


def smoke_quantize(mesh=None):
    cfg = SMOKE["llama2-7b"].scaled(**QUANT_KW)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    calib = calibration_tokens(cfg.vocab_size, 8, 32, device="cpu")
    recipe = QuantRecipe.uniform(PAPER_SETTINGS["2.25bpv_2d"]
                                 ).with_quantize_overrides(
        em_iters=4, codebook_update_iters=2)
    return quantize_model(model, params, calib, recipe=recipe,
                          hessian_mesh=mesh, pack=True)


def payload(tree) -> list:
    """Every tensor of a packed tree, the fields of its VQLinear leaves
    included, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in payload(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in payload(v)]
    if isinstance(tree, vql.VQLinear):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)
                if torch.is_tensor(getattr(tree, f.name))]
    return [tree]


def vql_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in vql_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in vql_leaves(v)]
    return [tree] if isinstance(tree, vql.VQLinear) else []


def test_quantize_on_a_host_mesh_equals_no_mesh(host_mesh):
    """``quantize_model(hessian_mesh=)`` at world 1 packs the same bits as
    the run without a mesh."""
    q_mesh, rep_mesh = smoke_quantize(host_mesh)
    q, rep = smoke_quantize()
    a, b = payload(q_mesh), payload(q)
    assert len(a) == len(b) and len(vql_leaves(q)) == 7
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert rep_mesh.achieved_bpv == rep.achieved_bpv == 2.25


def test_two_rank_quantize_packs_the_same_bits_on_both_ranks(tmp_path):
    """Two gloo ranks quantize on the merged Hessians: their packed
    payloads are bitwise equal, the bpv is 2.25, and each target's error
    is within 10% of the single-process run's (the merged Hessian's sum
    order differs, so near-tie assignments may flip)."""
    run_ranks(tmp_path, 2, "quantize", str(tmp_path))
    a, b = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2))
    pa, pb = payload(a["params"]), payload(b["params"])
    assert len(pa) == len(pb) and len(vql_leaves(a["params"])) == 7
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert a["bpv"] == b["bpv"] == 2.25
    _, rep = smoke_quantize()
    for name, e in rep.per_target.items():
        assert abs(a["errors"][name] - e["error"]) <= 0.1 * e["error"], name


@pytest.mark.parametrize("n,mp,pods", [
    (512, 16, 2), (492, 16, 2), (256, 16, 1), (300, 8, 1), (7, 2, 1),
    (1, 1, 1), (13, 1, 3)])
def test_plan_mesh_equals_reference(n, mp, pods):
    got = elastic.plan_mesh(n, model_parallel=mp, pods=pods)
    want = jelastic.plan_mesh(n, model_parallel=mp, pods=pods)
    assert (got.pod, got.data, got.model, got.spares, got.used) == (
        want.pod, want.data, want.model, want.spares, want.used)


@pytest.mark.parametrize("lost", [0, 1, 20, 100, 255])
def test_degrade_plan_equals_reference(lost):
    """The reference's ``TestElastic.test_plan_and_degrade``, for more
    losses: 512 devices in 2 pods of model_parallel 16."""
    got = elastic.degrade_plan(
        elastic.plan_mesh(512, model_parallel=16, pods=2), lost)
    want = jelastic.degrade_plan(
        jelastic.plan_mesh(512, model_parallel=16, pods=2), lost)
    assert dataclasses.astuple(got) == (want.pod, want.data, want.model,
                                        want.spares)
    assert got.model == 16 and got.used + got.spares == 512 - lost


def test_plan_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError):
        elastic.plan_mesh(8, model_parallel=16)


def test_hardware_names_the_card():
    hw = mesh_lib.HARDWARE
    assert "H100" in hw["card"] and "W" in hw["card"]
    assert (hw["peak_flops_bf16"], hw["hbm_bw"]) == (989e12, 3.35e12)


LAUNCH_ARGS = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
               "--sequences", "8", "--seq-len", "32", "--em-iters", "4",
               "--update-iters", "2"]


def test_launcher_hessian_mesh_under_torchrun(tmp_path):
    """``launch.quantize --hessian-mesh 2`` under ``torchrun
    --nproc-per-node 2``: both ranks print the backend (gloo on the CPU)
    and quantize; rank 0 alone writes the checkpoint and the events."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)))
    events = tmp_path / "events.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.quantize",
         *LAUNCH_ARGS, "--hessian-mesh", "2", "--out",
         str(tmp_path / "ck"), "--events-out", str(events)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    for r in (0, 1):
        assert f"hessian mesh: rank {r} of 2, backend gloo, device cpu" in out
    assert out.count("achieved 2.250 bpv") == 2
    assert out.count("packed checkpoint written") == 1
    assert (tmp_path / "ck").is_dir() and events.stat().st_size > 0


def test_launcher_hessian_mesh_needs_its_world():
    from repro_torch.launch import quantize as launch_quantize

    with pytest.raises(ValueError, match="nproc-per-node 2"):
        launch_quantize.main(LAUNCH_ARGS + ["--hessian-mesh", "2"])
