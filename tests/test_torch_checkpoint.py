"""Port parity for ``checkpoint/checkpointer.py`` and the launcher's
``--out``: the reference's ``TestCheckpoint`` cases; a checkpoint the
reference's ``launch/quantize.py --smoke`` writes (layers stacked) loads
into the port and gives the reference's teacher-forced logits; a checkpoint
the port writes (layers a list) restores in the reference bit for bit;
bf16 leaves the reference writes restore in the port bit for bit, and the
port writes the same bytes; the port launcher's ``--out`` round-trips bit
for bit with the reference's metadata keys; and a mixed recipe goes
quantize -> checkpoint -> restore -> serve on the port's engine (the dense
case of ``tests/core/test_recipe.py::test_mixed_recipe_roundtrip_checkpoint_serve``).
Every test writes under its own ``tmp_path``.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten_with_names
from repro.configs import SMOKE as JSMOKE
from repro.core import vq_linear as jvql
from repro.launch import quantize as j_launch
from repro.models import model_zoo as jzoo

from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _name
from repro_torch.configs import SMOKE
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import KeepDense, QuantRecipe, Quantize, Rule
from repro_torch.launch import quantize as launch_quantize
from repro_torch.models import model_zoo
from repro_torch.serve.engine import Engine, Request

LAUNCH_ARGS = ["--arch", "llama2-7b", "--smoke", "--sequences", "8",
               "--seq-len", "32", "--em-iters", "4", "--update-iters", "2"]
VQ_ARRAYS = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
             "scale_z")
VQ_STATIC = ("r", "c", "d", "k", "group_cols", "rows_per_band",
             "scale_block", "rule")
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int8: jnp.int8, torch.int32: jnp.int32}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _host(t: torch.Tensor) -> np.ndarray:
    """A port leaf's bits as the reference stores them."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def _jax_like(tree, stack: bool):
    """A reference ``like`` tree with the structure and static fields of a
    port params tree: layers as a list, or stacked (the reference's scan
    form)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, vql.VQLinear):
            arrs = {f: jnp.zeros(tuple(getattr(x, f).shape),
                                 _JDT[getattr(x, f).dtype])
                    for f in VQ_ARRAYS}
            arrs["words"] = arrs["words"].astype(jnp.uint32)
            return jvql.VQLinear(**arrs, **{f: getattr(x, f)
                                            for f in VQ_STATIC})
        return jnp.zeros(tuple(x.shape), _JDT[x.dtype])

    layers = [conv(lp) for lp in tree["layers"]]
    if stack:
        layers = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    return dict({k: conv(v) for k, v in tree.items() if k != "layers"},
                layers=layers)


def _port_quantized(recipe=None, seed=0):
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = model.init_params(seed=seed, device="cpu")
    calib = torch.randint(0, cfg.vocab_size, (8, 32),
                          generator=torch.Generator().manual_seed(9))
    if recipe is None:
        recipe = QuantRecipe.uniform(
            PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
        ).with_quantize_overrides(em_iters=4, codebook_update_iters=2)
    qparams, rep = quantize_model(model, params, calib, recipe=recipe,
                                  pack=True, chunk=4)
    return cfg, model, qparams, rep


@pytest.fixture(scope="module")
def port_q():
    return _port_quantized()


# ---------------------------------------------------------------------------
# the reference's TestCheckpoint
# ---------------------------------------------------------------------------

def test_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for s in (1, 2, 3):
        ck.save(s, {"a": tree["a"] * s, "b": {"c": tree["b"]["c"] * s}},
                {"tag": s})
    assert ck.all_steps() == [2, 3]  # gc kept last 2
    restored, meta = ck.restore(tree)
    assert meta["tag"] == 3
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(6).reshape(2, 3) * 3)
    assert restored["b"]["c"].tolist() == [3.0] * 4


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(7, {"x": torch.ones(8)})
    ck.wait()
    assert ck.latest_step() == 7
    assert ck.restore({"x": torch.zeros(8)})[0]["x"].tolist() == [1.0] * 8


def test_async_save_error_surfaces_in_wait(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    ck.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is reported once
    with pytest.raises(TypeError, match="tensors"):
        ck.save(2, {"x": (torch.ones(2),)})


def test_atomicity_no_partial_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(2)})
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_leaf_names_are_the_references(port_q):
    _, _, qparams, _ = port_q
    want = [n for n, _ in _flatten_with_names(_jax_like(qparams, False))[0]]
    assert [_name(p) for p, _ in _flatten(qparams)] == want
    assert "__layers___0___attn____wq__.words" in want


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_launch(tmp_path_factory):
    """The reference launcher's smoke checkpoint (layers stacked)."""
    out = tmp_path_factory.mktemp("ref_ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["quantize"] + LAUNCH_ARGS
                   + ["--out", str(out)])
        j_launch.main()
    return str(out)


def test_reference_checkpoint_loads_into_port(ref_launch, port_q):
    """The reference launcher's checkpoint restores into a tree the port
    quantized with the same recipe and gives the reference's teacher-forced
    logits on its own restored tree."""
    cfg, model, like, _ = port_q
    restored, meta = Checkpointer(ref_launch).restore(like)
    assert meta["arch"] == "llama2-7b" and meta["achieved_bpv"] == 2.25
    jck = JCheckpointer(ref_launch)
    j_restored, _ = jck.restore(_jax_like(like, stack=True))
    # bit for bit: row i of each stacked reference leaf is layer i's leaf
    for i, lp in enumerate(restored["layers"]):
        for sub in ("attn", "ffn"):
            for w, leaf in lp[sub].items():
                j_leaf = j_restored["layers"][sub][w]
                for f in VQ_ARRAYS:
                    assert _same_bits(_host(getattr(leaf, f)),
                                      np.asarray(getattr(j_leaf, f))[i])
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    jmodel = jzoo.build(JSMOKE["llama2-7b"].scaled(dtype="float32"))
    want = np.asarray(jmodel.forward(j_restored,
                                     {"tokens": jnp.asarray(tokens)},
                                     remat=False)[0])
    got = model.forward(restored, {"tokens": torch.from_numpy(tokens).long()})
    # f32 forward of 2 layers on the same packed leaves (gather form); sums
    # in another order
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-4, atol=1e-4)


def test_port_checkpoint_restores_in_reference(port_q, tmp_path):
    _, _, qparams, _ = port_q
    Checkpointer(str(tmp_path)).save(3, qparams, {"tag": "port"})
    j_restored, meta = JCheckpointer(str(tmp_path)).restore(
        _jax_like(qparams, stack=False))
    assert meta == {"tag": "port"}
    j_named = dict(_flatten_with_names(j_restored)[0])
    port_named = {_name(p): leaf for p, leaf in _flatten(qparams)}
    assert set(j_named) == set(port_named)
    for name, leaf in port_named.items():
        assert _same_bits(_host(leaf), np.asarray(j_named[name])), name
    words = j_named["__layers___1___ffn____w_out__.words"]
    assert np.asarray(words).dtype == np.uint32  # the reference's dtype


def test_reference_bf16_leaves_restore_into_port(tmp_path):
    """bf16 leaves as the reference writes them ('<V2' records): the port
    restores them bit for bit and writes the same bytes. The reference
    cannot read them back itself (ROADMAP.md section 3)."""
    rng = np.random.default_rng(1)
    vals = {"embed": rng.standard_normal((5, 4)),
            "layers": [{"w": rng.standard_normal(3)} for _ in range(2)],
            "scale": rng.standard_normal(2)}
    jtree = {"embed": jnp.asarray(vals["embed"], jnp.bfloat16),
             "layers": [{"w": jnp.asarray(lp["w"], jnp.bfloat16)}
                        for lp in vals["layers"]],
             "scale": jnp.asarray(vals["scale"], jnp.float32)}
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    jck = JCheckpointer(str(jdir))
    jck.save(0, jtree, {"k": 1})
    with pytest.raises(TypeError):
        jck.restore(jtree)

    def ptree(dtype_fn):
        return {"embed": dtype_fn(jtree["embed"]),
                "layers": [{"w": dtype_fn(lp["w"])}
                           for lp in jtree["layers"]],
                "scale": torch.from_numpy(np.array(jtree["scale"]))}

    def bf16(a):
        return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
            torch.bfloat16)

    restored, meta = Checkpointer(str(jdir)).restore(
        ptree(lambda a: torch.zeros(a.shape, dtype=torch.bfloat16)))
    assert meta == {"k": 1}
    assert restored["embed"].dtype == torch.bfloat16
    for name, leaf in _flatten_with_names(jtree)[0]:
        got = dict((_name(p), t) for p, t in _flatten(restored))[name]
        assert _same_bits(_host(got), np.asarray(leaf).view(
            np.int16 if leaf.dtype == jnp.bfloat16 else np.float32)), name
    Checkpointer(str(pdir)).save(0, ptree(bf16), {"k": 1})
    step = "step_0000000000"
    assert sorted(os.listdir(pdir / step)) == sorted(os.listdir(jdir / step))
    for f in os.listdir(jdir / step):
        if f.endswith(".npy"):
            assert (pdir / step / f).read_bytes() == (
                jdir / step / f).read_bytes(), f


def test_launcher_out_roundtrips(tmp_path, ref_launch, monkeypatch):
    """``--out``: the packed tree the launcher saves restores bit for bit,
    with the reference launcher's metadata keys and recipe JSON."""
    saved = {}

    class Recording(Checkpointer):
        def save(self, step, tree, metadata=None):
            saved.update(tree=tree, metadata=metadata)
            super().save(step, tree, metadata)

    monkeypatch.setattr(launch_quantize, "Checkpointer", Recording)
    out = tmp_path / "ckpt"
    launch_quantize.main(LAUNCH_ARGS + ["--device", "cpu", "--out",
                                        str(out)])
    restored, meta = Checkpointer(str(out)).restore(saved["tree"])
    for (p, a), (q, b) in zip(_flatten(saved["tree"]), _flatten(restored)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), _name(p)
    assert all(isinstance(leaf, vql.VQLinear) for leaf in
               restored["layers"][0]["attn"].values())
    with open(os.path.join(ref_launch, "step_0000000000",
                           "manifest.json")) as f:
        ref_meta = json.load(f)["metadata"]
    assert set(meta) == set(ref_meta)
    assert meta["recipe"] == ref_meta["recipe"]
    assert meta["achieved_bpv"] == ref_meta["achieved_bpv"] == 2.25
    for name, e in meta["per_target"].items():
        r = ref_meta["per_target"][name]
        assert (e["rule"], e["bpv"], e["numel"]) == (r["rule"], r["bpv"],
                                                    r["numel"])


def test_mixed_recipe_roundtrip_checkpoint_serve(tmp_path):
    def tiny(setting):
        return Quantize(dataclasses.replace(
            PAPER_SETTINGS[setting], em_iters=4, codebook_update_iters=0))

    named_dense = "layers.0.attn.wq"
    rec = QuantRecipe(
        rules=(Rule(named_dense, KeepDense("round-trip ablation")),
               Rule("group:attn", tiny("2.25bpv_2d")),
               Rule("group:mlp", tiny("4.125bpv_1d"))),
        default=tiny("2.25bpv_2d"), name="mixed-rt")
    cfg, model, qp, rep = _port_quantized(rec)
    assert rep.per_target[named_dense]["action"] == "keep_dense"
    assert isinstance(qp["layers"][0]["attn"]["wq"], torch.Tensor)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(0, qp, metadata={"recipe": rec.to_json(),
                             "per_target": rep.per_target,
                             "achieved_bpv": rep.achieved_bpv})
    restored, meta = ck.restore(qp)
    assert meta["recipe"]["name"] == "mixed-rt"
    assert meta["per_target"][named_dense]["action"] == "keep_dense"
    for (_, a), (_, b) in zip(_flatten(qp), _flatten(restored)):
        assert torch.equal(a, b)

    rng = np.random.RandomState(0)
    eng = Engine(model, restored, max_batch=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, size=6),
                    max_new_tokens=4) for i in range(3)]
    eng.run(reqs)
    assert all(len(r.out_tokens) >= 4 for r in reqs)


def test_restore_with_shardings(tmp_path):
    """Mirror of the reference's ``tests/substrate/test_checkpoint_sharded.
    py::test_restore_with_shardings``: on a 1 x 1 ``("data", "model")``
    mesh, ``restore(shardings=)`` with (mesh, spec) pairs gives DTensors
    placed by the specs, holding the saved values; a save of those
    DTensors writes the same whole arrays."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common as cm

    mesh = mesh_lib.make_host_mesh("cpu")
    try:
        tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(4)}
        ck = Checkpointer(str(tmp_path))
        ck.save(3, tree)
        sh = {"w": mesh_lib.NamedSharding(mesh, cm.P("data", "model")),
              "b": mesh_lib.NamedSharding(mesh, cm.P(None))}
        restored, _ = ck.restore(tree, shardings=sh)
        assert restored["w"].placements == (Shard(0), Shard(1))
        assert restored["b"].placements == (Replicate(), Replicate())
        assert torch.equal(restored["w"].full_tensor(),
                           torch.arange(16.0).reshape(4, 4))
        ck.save(4, restored)
        again, _ = ck.restore(tree, step=4)
        assert torch.equal(again["w"], tree["w"])
        assert torch.equal(again["b"], tree["b"])
    finally:
        dist.destroy_process_group()
