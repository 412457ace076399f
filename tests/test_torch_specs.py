"""The port's sharding specs against the reference's, without a process
group: every family's ``param_specs`` tree matches its parameter tree
(the mirror of ``tests/models/test_smoke.py::
test_param_specs_match_param_trees``), each leaf's spec is the reference's
with the stacked layer axes dropped, ``sanitize_specs`` gives the
reference's answer on meshes (1, 1), (2, 2), (1, 4) and (4, 1) (the
reference reads only ``axis_names`` and ``devices.shape``, so a stand-in
mesh serves and jax needs no extra devices), ``placements`` turns specs
into DTensor placements, and ``optimizer.state_specs`` mirrors the
reference's.
"""
import functools
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JARCHS
from repro.configs import SMOKE as JSMOKE
from repro.models import common as jcm
from repro.models import model_zoo as jzoo
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, SMOKE
from repro_torch.models import common as cm
from repro_torch.models import model_zoo
from repro_torch.train import optimizer as opt

MESHES = [(1, 1), (2, 2), (1, 4), (4, 1)]


def jmesh(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape))


@functools.lru_cache(maxsize=None)
def reference(name: str, full: bool = False):
    """(abstract params, param specs) of the reference's model."""
    cfg = (JARCHS if full else JSMOKE)[name]
    model = jzoo.build(cfg if full else cfg.scaled(dtype="float32"))
    return jzoo.abstract_params(model), model.param_specs()


@functools.lru_cache(maxsize=None)
def port(name: str, full: bool = False):
    cfg = (ARCHS if full else SMOKE)[name]
    model = model_zoo.build(cfg if full else cfg.scaled(dtype="float32"))
    return model_zoo.abstract_params(model), model.param_specs()


def dropped(ref, like):
    """The reference's spec tree on the port's tree: a list in the port
    where the reference stacks takes each item from the stacked subtree
    with its leading spec entry dropped."""
    if isinstance(like, list):
        if isinstance(ref, list):
            return [dropped(r, x) for r, x in zip(ref, like)]
        return [dropped(jax.tree.map(lambda s: JP(*s[1:]), ref,
                                     is_leaf=lambda s: isinstance(s, JP)), x)
                for x in like]
    if isinstance(like, dict):
        assert sorted(ref) == sorted(like)
        return {k: dropped(ref[k], like[k]) for k in like}
    return tuple(ref)


def pairs(got, want, path=""):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        return [p for k in got for p in pairs(got[k], want[k],
                                               f"{path}.{k}")]
    if isinstance(got, list):
        assert len(got) == len(want), path
        return [p for i, (a, b) in enumerate(zip(got, want))
                for p in pairs(a, b, f"{path}[{i}]")]
    return [(path, got, want)]


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_param_specs_match_param_trees(name):
    """The spec tree has the parameter tree's containers, a ``P`` at each
    tensor, none longer than its tensor's rank."""
    shapes, specs = port(name)
    for path, spec, t in pairs(specs, shapes):
        assert isinstance(spec, cm.P), path
        assert len(spec) <= t.dim(), (path, spec, tuple(t.shape))
        assert t.device.type == "meta"


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_param_specs_are_the_references(name):
    """Each leaf's spec is the reference's, its stacked layer axes (one,
    two for the hybrid trunk) dropped."""
    _, specs = port(name)
    want = dropped(reference(name)[1], specs)
    for path, got, w in pairs(specs, want):
        assert tuple(got) == w, path


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", sorted(SMOKE))
def test_sanitize_specs_is_the_references(name, mesh):
    """``sanitize_specs`` on the port's tree against the reference's on
    its own (stacked) tree: the same axes kept and dropped, leaf by
    leaf."""
    jshapes, jspecs = reference(name)
    shapes, specs = port(name)
    want = dropped(jcm.sanitize_specs(jshapes, jspecs, jmesh(mesh)), specs)
    got = cm.sanitize_specs(shapes, specs, {"data": mesh[0],
                                            "model": mesh[1]})
    for path, g, w in pairs(got, want):
        assert tuple(g) == w, (path, mesh)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 8), (16, 16)])
@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-moe-30b-a3b"])
def test_sanitize_specs_full_width(name, mesh):
    """The same at the full configs the chip trains (shapes from meta
    tensors, nothing allocated): e.g. Qwen3-MoE's 4 KV heads of 128 keep
    the model axis on wk at 8 (a split mid-head) and its 151,936-token
    vocabulary pads to 152,064, which 16 divides."""
    jshapes, jspecs = reference(name, full=True)
    shapes, specs = port(name, full=True)
    want = dropped(jcm.sanitize_specs(jshapes, jspecs, jmesh(mesh)), specs)
    got = cm.sanitize_specs(shapes, specs, {"data": mesh[0],
                                            "model": mesh[1]})
    for path, g, w in pairs(got, want):
        assert tuple(g) == w, (path, mesh)


def test_sanitize_drops_absent_and_non_dividing_axes():
    specs = {"a": cm.P("data", "model"), "b": cm.P(("pod", "data"), None),
             "c": cm.P("model"), "d": None}
    shapes = {"a": (6, 8), "b": (4, 3), "c": (5,), "d": (2, 2)}
    got = cm.sanitize_specs(shapes, specs, {"data": 2, "model": 4})
    assert got == {"a": ("data", "model"), "b": ("data", None),
                   "c": (None,), "d": ()}
    assert all(isinstance(s, cm.P) for s in got.values())


@pytest.mark.parametrize("spec,want", [
    (cm.P("data", "model"), [Shard(0), Shard(1)]),
    (cm.P("model", "data"), [Shard(1), Shard(0)]),
    (cm.P(None, "model"), [Replicate(), Shard(1)]),
    (cm.P("model", None, "data"), [Shard(2), Shard(0)]),
    (cm.P(None), [Replicate(), Replicate()]),
    (cm.P(), [Replicate(), Replicate()]),
])
def test_placements_of_a_spec(spec, want):
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert cm.placements(spec, mesh) == want


@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-moe-30b-a3b"])
def test_state_specs_mirror_the_references(name):
    """The step replicated; m, v and master the parameters' specs, leaf by
    leaf the reference's."""
    jspecs = reference(name)[1]
    _, specs = port(name)
    want, got = jopt.state_specs(jspecs), opt.state_specs(specs)
    assert tuple(got.step) == tuple(want.step) == ()
    for field in ("m", "v", "master"):
        for path, g, w in pairs(getattr(got, field),
                                dropped(getattr(want, field), specs)):
            assert tuple(g) == w, (field, path)


def axis_of(tp: int, model_rank: int = 0):
    """A ``parallel.ModelAxis`` of a (1, tp) mesh without a process group:
    the sizes and the rank the layers' split rules read."""
    from repro_torch.models import parallel as par

    axis = par.ModelAxis.__new__(par.ModelAxis)
    axis.dp, axis.tp, axis.data_rank, axis.model_rank = 1, tp, 0, model_rank
    axis.data_group = axis.model_group = None
    return axis


FAMILY_ARCHS = ["llama2-7b", "qwen3-moe-30b-a3b", "phi-3-vision-4.2b",
                "xlstm-125m", "zamba2-7b", "whisper-small"]


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_param_modes_cover_the_specs(name, tp, full):
    """``Model.param_modes`` (each layer module's ``split_modes``) names
    every leaf of ``param_specs`` and no other, and each leaf the forward
    reads split (SPLIT) keeps the model axis in its sanitized spec, for
    each of the six families at smoke and full widths (at 8, Qwen3-MoE's
    4 KV heads split mid-head: wk / wv read whole; xLSTM-125M's 4 heads
    do not split: its blocks run whole but for the sLSTM FFN)."""
    from repro_torch.models import parallel as par

    shapes, specs = port(name, full=full)
    cfg = (ARCHS if full else SMOKE)[name]
    modes = model_zoo.build(cfg).param_modes(axis_of(tp))
    sane = cm.sanitize_specs(shapes, specs, {"data": 1, "model": tp})
    got = pairs(modes, sane)
    assert len(got) == len(opt.tree_leaves(specs))
    for path, mode, spec in got:
        assert mode in (par.SPLIT, par.FULL, par.FULL_SUM), path
        assert tp > 1 or mode == par.FULL, path
        if mode == par.SPLIT:
            assert "model" in [a for e in spec for a in cm._axes(e)], path


def test_a_leaf_without_a_mode_raises(monkeypatch):
    """A leaf added to a layer's specs and not to its ``split_modes`` is
    an error, not a silent FULL (whose gradient would be one rank's
    part)."""
    from repro_torch.models import attention, transformer

    real = attention.specs
    monkeypatch.setattr(attention, "specs",
                        lambda cfg: {**real(cfg), "wx": cm.P("model")})
    with pytest.raises(KeyError, match="wx"):
        transformer.param_modes(SMOKE["llama2-7b"], axis_of(2))
