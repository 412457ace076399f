"""Atomic, async-capable checkpointing (port of
``repro/checkpoint/checkpointer.py``), on the reference's on-disk layout.

Layout: ``<dir>/step_<N:010d>/`` with one ``.npy`` per leaf and a
``manifest.json`` holding ``step``, ``leaves`` (name, dtype, shape) and the
caller's ``metadata``. A leaf's file name is the reference's: its
``jax.tree_util.keystr`` path with every character outside
``[A-Za-z0-9_.-]`` replaced by ``_`` (dict keys in sorted order as
``['key']``, list items as ``[i]``, dataclass fields as ``.field``), so
``params["layers"][0]["attn"]["wq"].words`` is
``__layers___0___attn____wq__.words``. Writes go to a ``.tmp-`` staging
directory renamed into place when complete, so a crashed writer never
leaves a partial step.

Leaves are torch tensors; containers are dicts, lists, NamedTuples (a
``TrainState`` and its ``AdamWState``: every field, as ``.field``, the
scalar step a 0-dim leaf) and dataclasses (``VQLinear``): a dataclass
field holding a tensor is a leaf, any other field is static and comes back
from ``like`` on restore, as in the reference. Dtypes on disk are the
reference's:

* bfloat16 leaves are raw 2-byte records (numpy descr ``'<V2'``, manifest
  dtype ``"bfloat16"``), as ``np.save`` writes the reference's bf16
  arrays; they restore as ``torch.bfloat16`` with the same bits;
* packed code words (a dataclass's ``words``, int32 in the port) are
  written as uint32, the reference's dtype; uint32 leaves restore as int32
  with the same bits.

The reference stacks homogeneous layers on a leading axis (its scan form)
where the port keeps a list, so ``restore`` reads item i of a list from its
own file or, when the checkpoint holds the stacked form, as row i of the
stacked leaf (for nested lists, such as the hybrid trunk's groups of
layers, row [g][j]). ``save`` writes the hybrid trunk (``params["mamba"]``,
a list of groups of layers) in the reference's layout: one stacked
(n_groups, per, ...) leaf per array when its layers stack
(``core/adapters/base.blocks_stackable``), the list of lists otherwise (a
mixed recipe).

DTensor leaves (a train state on a mesh) are saved as their whole logical
arrays, the same bytes as an unsharded save, so a checkpoint does not
depend on the mesh that wrote it. Gathering a leaf (``parallel.whole``) is
a collective: every rank calls ``save``, which gathers every leaf before
the writer thread gets the arrays; rank 0 alone writes, and the next
``wait`` (``save`` calls it first) holds every rank until it has.
``restore`` places a leaf on a mesh when ``shardings=`` gives it a
(mesh, spec) pair (``launch/mesh.NamedSharding``) or, without one, when
``like``'s leaf is a DTensor (its mesh and placements); other leaves come
back whole on ``like``'s device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import common as cm
from repro_torch.models import parallel as par

_BF16 = "bfloat16"
# dataclass fields holding the reference's uint32 code words as int32
_UINT32_FIELDS = ("words",)


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


def _children(node):
    """[(key piece, child, is_list_item)] of a container, or None for a
    tensor leaf. Order follows jax: sorted dict keys, dataclass field
    order."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k], False) for k in sorted(node)]
    if isinstance(node, list):
        return [(f"[{i}]", c, True) for i, c in enumerate(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return [(f".{f}", getattr(node, f), False) for f in node._fields]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name), False)
                for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name), torch.Tensor)]
    if isinstance(node, torch.Tensor):
        return None
    raise TypeError(f"checkpoint trees hold dicts, lists, NamedTuples, "
                    f"dataclasses and tensors, not {type(node).__name__}")


def _flatten(tree, path=()):
    """[(path, leaf)] in jax's leaf order; a path is a tuple of
    (key piece, is_list_item) pairs."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for piece, child, seq in kids:
        out += _flatten(child, path + ((piece, seq),))
    return out


def _name(path) -> str:
    return _sanitize("".join(piece for piece, _ in path))


def _rebuild(like, values, path=()):
    """``like``'s structure with each leaf replaced by values[path]."""
    kids = _children(like)
    if kids is None:
        return values[path]
    new = {piece: _rebuild(child, values, path + ((piece, seq),))
           for piece, child, seq in kids}
    if isinstance(like, dict):
        return {k: new[f"[{k!r}]"] for k in like}
    if isinstance(like, list):
        return [new[f"[{i}]"] for i in range(len(like))]
    if isinstance(like, tuple):  # NamedTuple
        return type(like)(**{f: new[f".{f}"] for f in like._fields})
    return dataclasses.replace(like, **{p[1:]: v for p, v in new.items()})


def _to_host(path, leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy array as the reference writes it, manifest dtype)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
    arr = t.numpy()
    if path and path[-1][0][1:] in _UINT32_FIELDS and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr, str(arr.dtype)


def _write(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    # np.save records the reference's bf16 arrays under their dtype.str,
    # '<V2'; numpy's own V2 arrays would say '|V2'. Write the same header.
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A loaded leaf as a torch tensor with the same bits."""
    if dtype == _BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _zip_shardings(like, shardings):
    """``shardings``' leaves in ``like``'s leaf order (``_flatten``'s):
    ``shardings`` has ``like``'s containers down to its tensors."""
    kids = _children(like)
    if kids is None:
        return [shardings]
    if isinstance(like, dict):
        return [s for k in sorted(like)
                for s in _zip_shardings(like[k], shardings[k])]
    if isinstance(like, list):
        return [s for a, b in zip(like, shardings)
                for s in _zip_shardings(a, b)]
    if isinstance(like, tuple):  # NamedTuple
        return [s for f in like._fields
                for s in _zip_shardings(getattr(like, f),
                                        getattr(shardings, f))]
    raise TypeError(f"no shardings for {type(like).__name__} leaves")


def _reference_layout(tree):
    """``tree`` with a stackable hybrid trunk stacked (n_groups, per, ...),
    as the reference's adapter finalizes and saves it."""
    trunk = tree.get("mamba") if isinstance(tree, dict) else None
    if not (isinstance(trunk, list) and trunk
            and all(isinstance(g, list) for g in trunk)):
        return tree
    from repro_torch.core.adapters.base import blocks_stackable, stack_blocks

    if not blocks_stackable([lp for grp in trunk for lp in grp]):
        return tree
    return dict(tree, mamba=stack_blocks([stack_blocks(g) for g in trunk]))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._ranks_wait = False  # a save on a mesh waits for rank 0
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: dict | None = None):
        leaves = _flatten(_reference_layout(tree))
        sharded = any(cm.is_dtensor(leaf) for _, leaf in leaves)
        self.wait()
        # snapshot now, in the reference's layout; a DTensor leaf whole
        # (every rank gathers every leaf, in order)
        writer = not sharded or dist.get_rank() == 0
        host = []
        for path, leaf in leaves:
            if cm.is_dtensor(leaf):
                leaf = par.whole(leaf)
            if writer:
                host.append((_name(path), *_to_host(path, leaf)))
        self._ranks_wait = sharded
        if not writer:
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_async, args=(step, host, metadata))
            self._thread.start()
        else:
            self._save_sync(step, host, metadata)

    def _save_async(self, step: int, host: list, metadata: dict | None):
        try:
            self._save_sync(step, host, metadata)
        except Exception as e:  # re-raised by wait()
            self._error = e

    def _save_sync(self, step: int, host: list, metadata: dict | None):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = os.path.join(self.dir, f".tmp-step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "metadata": metadata or {}}
        for name, arr, dtype in host:
            _write(os.path.join(tmp, name + ".npy"), arr, dtype)
            manifest["leaves"].append(
                {"name": name, "dtype": dtype, "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self):
        """Join a pending async save (after a save on a mesh, every rank
        waits here until rank 0's has landed); raise the error it met, if
        any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._ranks_wait:
            self._ranks_wait = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like``; returns (tree,
        metadata). ``shardings``: a tree with ``like``'s containers whose
        leaves are (mesh, spec) pairs (``launch.mesh.NamedSharding``) or
        None; a leaf with a pair comes back as a DTensor placed by its
        spec sanitized against the mesh, a DTensor ``like`` leaf without
        one on its mesh and placements, any other on the device of
        ``like``'s leaf."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}
        loaded: dict[str, np.ndarray] = {}

        def load(name):
            if name not in loaded:
                loaded[name] = np.load(os.path.join(d, name + ".npy"))
            return loaded[name]

        flat = _flatten(like)
        shards = (_zip_shardings(like, shardings) if shardings is not None
                  else [None] * len(flat))
        values = {}
        for (path, ref), sh in zip(flat, shards):
            name, row = _name(path), ()
            if name not in dtypes:
                # the reference's stacked form: drop the first run of list
                # indices from the path and take that row of the stacked
                # leaf
                i = next((j for j, (_, seq) in enumerate(path) if seq), None)
                if i is None:
                    raise KeyError(f"leaf {name!r} is not in {d}")
                n = i
                while n < len(path) and path[n][1]:
                    n += 1
                row = tuple(int(piece[1:-1]) for piece, _ in path[i:n])
                name = _name(path[:i] + path[n:])
                if name not in dtypes:
                    raise KeyError(f"leaf {_name(path)!r} (or its stacked "
                                   f"form {name!r}) is not in {d}")
            arr = load(name)
            if row:
                arr = arr[row]
            t = _from_host(arr, dtypes[name], ref.device)
            if sh is not None:
                spec = cm.sanitize_specs(t, sh.spec, sh.mesh)
                t = cm.place(t, sh.mesh, cm.placements(spec, sh.mesh))
            elif cm.is_dtensor(ref):
                t = cm.place(t, ref.device_mesh, ref.placements)
            values[path] = t
        return _rebuild(like, values), manifest["metadata"]
