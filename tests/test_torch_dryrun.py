"""The port's dry run (``repro_torch.launch.dryrun``, ``report``) against
the reference's (``repro.launch.dryrun``):

* exactly the reference's: ``active_param_counts``; ``vq_abstract_params``'
  shapes (its stacked layer axes laid out as the port's per-layer leaves)
  and ``vq_param_bytes`` for every arch; every family's ``cache_specs``
  with and without ``seq_shard``; the ``cache_shardings`` policy,
  ``batch_sharding`` and ``plan_microbatches`` for every cell on the H100
  production meshes, (32, 8) and (2, 32, 8); ``all_cells``, the cell ids
  and the skip reasons. The reference's functions read only a mesh's
  ``axis_names`` and ``devices.shape``, so a stand-in mesh serves them
  (its ``NamedSharding`` replaced by the spec), and jax needs no extra
  devices;
* on a fake world of 8 as a (4, 2) mesh (``tests/dryrun_worker.py``, a
  process of its own), ``run_cell`` at smoke size is ``ok`` for every
  family and kind, ``--vq`` decode included; the train cells' counted
  all-gather bytes are the ``Layout``'s; and at mesh (1, 1) the traced
  FLOPs equal ``FlopCounterMode`` on the same step run on the CPU;
* on 2 gloo ranks (``tests/dryrun_serve_worker.py``), decode with a
  head-split cache and with sequence-split caches matches single-device
  decode in f32 (rtol 1e-5 plus 1e-6 max|logits|);
* ``report`` renders every table from cell records on disk.
"""
import collections
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

import ranks
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import VQConfig
from repro_torch.launch import dryrun, report
from repro_torch.models import model_zoo
from repro_torch.obs import work

MESHES = {False: ((32, 8), ("data", "model")),
          True: ((2, 32, 8), ("pod", "data", "model"))}
SERVE_SHAPES = [s for s, c in SHAPES.items() if c.kind != "train"]


def _import_reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS for 512 host devices when it
    is imported; this process's jax is already initialised, and the
    variable is put back so that no later subprocess inherits it."""
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jdr
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdr


JDR = _import_reference_dryrun()


@pytest.fixture(scope="module")
def jdr():
    """The reference's dry run with ``NamedSharding(mesh, spec)`` giving
    the spec back."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDR, "NamedSharding", lambda mesh, spec: spec)
        yield JDR


def jmesh(multi_pod):
    shape, names = MESHES[multi_pod]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def tmesh(multi_pod):
    shape, names = MESHES[multi_pod]
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


@pytest.fixture(scope="module")
def jmodels():
    return {name: jzoo.build(cfg) for name, cfg in JARCHS.items()}


def spec_list(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_param_counts(arch, jdr, jmodels):
    assert dryrun.active_param_counts(model_zoo.build(ARCHS[arch])) == \
        jdr.active_param_counts(jmodels[arch])


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return str(k)


def _ref_vq_leaves(shapes) -> list:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(tuple(_key(k) for k in path), tuple(leaf.shape),
             np.dtype(leaf.dtype).itemsize) for path, leaf in flat]


def _port_vq_leaves(shapes) -> list:
    out = []
    for path, leaf in dryrun._walk_paths(shapes):
        if isinstance(leaf, vql.VQLinear):
            for f in ("words", "codebooks", "cb_scale", "scale_sint",
                      "scale_a", "scale_z"):
                t = getattr(leaf, f)
                out.append((path + (f,), tuple(t.shape), t.element_size()))
        else:
            out.append((path, tuple(leaf.shape), leaf.element_size()))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_vq_abstract_params(arch, jdr, jmodels):
    """The same leaves as the reference's: each reference leaf whose path
    has k fewer list indices than the port's carries k stacked axes, laid
    out as prod(those axes) per-layer leaves here."""
    jshapes, _ = jdr.vq_abstract_params(jmodels[arch], jdr.SERVE_VQ)
    shapes, specs = dryrun.vq_abstract_params(model_zoo.build(ARCHS[arch]),
                                              dryrun.SERVE_VQ)
    assert dryrun.vq_param_bytes(shapes) == jdr.vq_param_bytes(jshapes)

    def names(path):
        return tuple(p for p in path if not isinstance(p, int))

    port = _port_vq_leaves(shapes)
    n_int = {names(p): sum(isinstance(x, int) for x in p) for p, _, _ in port}
    got = collections.Counter((names(p), s, b) for p, s, b in port)
    want = collections.Counter()
    for path, shape, b in _ref_vq_leaves(jshapes):
        k = n_int[names(path)] - sum(isinstance(x, int) for x in path)
        want[(names(path), shape[k:], b)] += math.prod(shape[:k])
    assert got == want
    # every VQ leaf's spec tree mirrors it
    for (path, leaf), spec in zip(dryrun._walk_paths(shapes),
                                  dryrun.opt.tree_leaves(specs)):
        assert isinstance(spec, vql.VQLinear) == isinstance(leaf,
                                                            vql.VQLinear)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_pairs(fam, ref, port):
    """(reference spec with its stacked axes dropped, port spec) of every
    cache leaf."""
    if fam == "hybrid":
        for group in port.mamba:
            for one in group:
                yield tuple(ref.mamba.h)[2:], tuple(one.h)
                yield tuple(ref.mamba.conv)[2:], tuple(one.conv)
        for one in port.attn:
            yield tuple(ref.attn.k)[1:], tuple(one.k)
            yield tuple(ref.attn.v)[1:], tuple(one.v)
    elif fam == "audio":
        for i in range(len(port.self_kv)):
            yield tuple(ref.self_kv.k)[1:], tuple(port.self_kv[i].k)
            yield tuple(ref.self_kv.v)[1:], tuple(port.self_kv[i].v)
            yield tuple(ref.cross_k)[1:], tuple(port.cross_k[i])
            yield tuple(ref.cross_v)[1:], tuple(port.cross_v[i])
    elif isinstance(ref, list):  # the reference's layer list (xLSTM)
        assert len(ref) == len(port)
        for r, p in zip(ref, port):
            for a, b in zip(r, p):
                yield tuple(a), tuple(b)
    else:  # a homogeneous stack: one stacked leaf a field
        for one in port:
            yield tuple(ref.k)[1:], tuple(one.k)
            yield tuple(ref.v)[1:], tuple(one.v)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs(arch, seq_shard, jmodels):
    port = model_zoo.build(ARCHS[arch]).cache_specs(seq_shard=seq_shard)
    ref = jmodels[arch].cache_specs(seq_shard=seq_shard)
    pairs = list(_cache_pairs(ARCHS[arch].family, ref, port))
    assert pairs and all(a == b for a, b in pairs)


CELLS = [(a, s, mp, kv8) for a in sorted(ARCHS) for s in SERVE_SHAPES
         for mp in (False, True) for kv8 in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod,kv8", CELLS)
def test_cache_shardings(arch, shape, multi_pod, kv8, jdr, jmodels):
    """The policy on every serving cell's cache, at the cell's batch and
    length, as the reference's run_cell picks seq_shard."""
    import jax.numpy as jnp

    sh = SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    dpn = math.prod(MESHES[multi_pod][0][:-1])
    seq_shard = shape == "long_500k" or (sh.kind == "decode" and B < dpn)
    model = model_zoo.build(ARCHS[arch])
    port = dryrun.cache_shardings(
        model, tmesh(multi_pod),
        dryrun.abstract_cache(model, B, S, torch.float8_e4m3fn if kv8
                              else torch.bfloat16), seq_shard=seq_shard)
    jm = jmodels[arch]
    ref = jdr.cache_shardings(
        jm, jmesh(multi_pod),
        jdr.abstract_cache(jm, B, S, jnp.float8_e4m3fn if kv8
                           else jnp.bfloat16), seq_shard=seq_shard)
    pairs = list(_cache_pairs(ARCHS[arch].family, ref, port))
    assert pairs and all(a == b for a, b in pairs)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batches_and_microbatches(arch, multi_pod, jdr):
    for shape, sh in SHAPES.items():
        assert dryrun.plan_microbatches(ARCHS[arch], sh, tmesh(multi_pod)) \
            == jdr.plan_microbatches(JARCHS[arch], JSHAPES[shape],
                                     jmesh(multi_pod))
        kind = sh.kind
        port = dryrun.batch_sharding(
            tmesh(multi_pod), dryrun.abstract_batch(ARCHS[arch], sh, kind))
        ref = jdr.batch_sharding(
            jmesh(multi_pod), jdr.abstract_batch(JARCHS[arch], JSHAPES[shape],
                                                 kind))
        assert {k: spec_list(v) for k, v in port.items()} == \
            {k: spec_list(v) for k, v in ref.items()}
        assert {k: (tuple(v.shape), v.element_size())
                for k, v in dryrun.abstract_batch(
                    ARCHS[arch], sh, kind).items()} == \
            {k: (tuple(v.shape), np.dtype(v.dtype).itemsize)
             for k, v in jdr.abstract_batch(JARCHS[arch], JSHAPES[shape],
                                            kind).items()}


def test_cells_ids_and_skips(jdr):
    assert dryrun.all_cells() == jdr.all_cells()
    assert dryrun.all_cells(False) == jdr.all_cells(False)
    for arch, shape, mp, vq in dryrun.all_cells() + [
            ("qwen3-1.7b", "train_4k", False, True)]:
        ok, _ = dryrun.shape_applicable(ARCHS[arch], SHAPES[shape])
        if ok and not (vq and SHAPES[shape].kind == "train"):
            continue
        assert dryrun.run_cell(arch, shape, multi_pod=mp, vq=vq,
                               save=False) == \
            jdr.run_cell(arch, shape, multi_pod=mp, vq=vq, save=False)
    for args in [("yi-34b", "decode_32k", True, True, True),
                 ("zamba2-7b", "long_500k", False, False, False)]:
        arch, shape, mp, vq, kv8 = args
        want = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}" + (
            "__vq" if vq else "") + ("__kv8" if kv8 else "")
        assert dryrun.cell_id(*args) == want


# ---------------------------------------------------------------------------
# pieces without a world
# ---------------------------------------------------------------------------

def test_flash_pairs_closed_form():
    for Sq, Sk, off in [(1, 1, 0), (8, 8, 0), (4, 16, 12), (16, 4, 0),
                        (5, 7, 3), (3, 9, 20)]:
        brute = sum(min(Sk, off + i + 1) for i in range(Sq))
        assert work.flash_pairs(Sq, Sk, off, True) == brute
    assert work.flash_pairs(5, 7, 0, False) == 35


def test_vq_shard():
    """A VQ leaf's row parts concatenate to its output, its column-group
    parts (and a fused leaf's input windows) sum to it."""
    gen = torch.Generator().manual_seed(0)
    W = torch.randn((64, 512), generator=gen)
    cfg = VQConfig(d=2, bits_per_dim=2, group_size=256, em_iters=2,
                   codebook_update_iters=0)
    q = vql.quantize_array(W, None, cfg, generator=gen)
    f = vql.prepare_fused(q)
    x = torch.randn((3, 512), generator=gen)
    y = vql.fused_matmul(x, f)
    rows = torch.cat([vql.fused_matmul(x, vql.shard(f, 1, 2, i))
                      for i in range(2)], -1)
    assert torch.equal(rows, y)
    parts = [vql.fused_matmul(x.chunk(2, -1)[i],
                              vql.prepare_fused(vql.shard(q, 0, 2, i)))
             for i in range(2)]
    assert torch.allclose(sum(parts), y, rtol=1e-5, atol=1e-5)
    # 2 column groups do not split 8 ways: the fused leaf keeps them whole
    wins = [vql.shard(f, 0, 8, i) for i in range(8)]
    assert all(w.in_window == (64 * i, 64) for i, w in enumerate(wins))
    parts = [vql.fused_matmul(x.chunk(8, -1)[i], w)
             for i, w in enumerate(wins)]
    assert torch.allclose(sum(parts), y, rtol=1e-5, atol=1e-5)
    # densified (the hybrid's shared block), a window is its columns
    dense = vql.fused_dequantize(f, torch.float32)
    assert torch.equal(vql.fused_dequantize(wins[3], torch.float32),
                       dense[:, 192:256])
    with pytest.raises(ValueError):
        vql.shard(q, 0, 8, 0)


# ---------------------------------------------------------------------------
# fake worlds and ranks (subprocesses)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def subprocs(tmp_path_factory):
    """The fake-world worker and the 2 ranks of the sharded decode, run
    side by side: (the worker's results, its cells directory, the ranks'
    results)."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {
        "worker": ranks.start([sys.executable,
                               str(ranks.ROOT / "tests" / "dryrun_worker.py"),
                               str(d / "out.json"), str(d / "cells")]),
        "ranks": ranks.start(ranks.torchrun(
            2, ranks.ROOT / "tests" / "dryrun_serve_worker.py",
            d / "serve.json"))}
    ranks.finish(procs)
    with open(d / "out.json") as f, open(d / "serve.json") as g:
        return json.load(f), d / "cells", json.load(g)


@pytest.fixture(scope="module")
def worker(subprocs):
    return subprocs[:2]


FAMILIES = ["audio", "dense", "hybrid", "moe", "ssm", "vlm"]
KINDS = [(f, k) for f in FAMILIES for k in ("train", "prefill", "decode",
                                            "vq")]
KINDS += [("hybrid", "long"), ("ssm", "long")]


@pytest.mark.parametrize("fam,kind", KINDS)
def test_run_cell_ok_on_a_fake_world(worker, fam, kind):
    cell = worker[0]["cells"][f"{fam}/{kind}"]
    assert cell["status"] == "ok", cell["error"]
    assert cell["fits"] and cell["flops"]["total"] > 0
    assert cell["memory"]["peak_bytes"] >= cell["memory"]["argument_bytes"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_counted_gathers_are_the_layouts(worker, fam):
    g = worker[0]["gathers"][fam]
    want = {k: v for k, v in g["layout"].items() if v}
    assert g["counted"] == want


@pytest.mark.parametrize("step", ["dense/train", "moe/train"] + [
    f"{f}/decode" for f in FAMILIES])
def test_traced_flops_equal_a_real_cpu_step(worker, step):
    r = worker[0]["flops"][step]
    assert r["status"] == "ok" and r["traced"] == r["measured"] > 0


def test_stepwise_cell_equals_its_direct_trace(worker):
    """A cell traced at two lengths and extended (the xLSTM's long train
    and prefill cells) counts what the token-by-token trace counts: the
    FLOPs and collective bytes exactly; the peak within 0.5% (at smoke
    widths a token's tensors are smaller than the allocator's 512-byte
    blocks, so the rounded peak is not exactly affine; at the full width
    it is, at 8, 16 and 24 tokens)."""
    r = worker[0]["stepwise"]
    assert r["extended"][3] == list(dryrun.STEPWISE_TOKENS)
    assert r["extended"][0] == r["direct"][0]
    assert r["extended"][2] == r["direct"][2]
    assert r["extended"][1] == pytest.approx(r["direct"][1], rel=5e-3)


def test_report_renders(worker):
    cells = report.load(str(worker[1]))
    assert len(cells) == len(KINDS)
    text = report.render(cells)
    for heading in ("## Summary", "## Dry-run table",
                    "## Roofline (single-pod, 256 cards)",
                    "## Roofline (multi-pod, 512 cards)",
                    "## VQ vs bf16 serving"):
        assert heading in text
    assert "fits 80 GB less the reserve" in text
    assert f"{len(KINDS)} cells: {len(KINDS)} traced ok" in text
    # every ok cell has a roofline row (the smoke cells are "pod1")
    assert text.count("| **") >= len(KINDS)


@pytest.fixture(scope="module")
def sharded_decode(subprocs):
    return subprocs[2]


@pytest.mark.parametrize("case", ["heads", "seq_model", "seq_data_model"])
def test_sharded_decode_matches_single_device(sharded_decode, case):
    r = sharded_decode[case]
    assert r["ok"], r
    assert r["heads"] == (case == "heads")
    assert r["seq_n"] == (1 if case == "heads" else 2)
