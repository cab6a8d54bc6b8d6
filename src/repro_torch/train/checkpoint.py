"""Checkpoints with atomic publish and restore onto any device, in the
JAX package's on-disk layout (``repro.train.checkpoint``):

    ckpt_dir/
      step_000000123/        <- published atomically by a rename
        manifest.json        <- step, time, each leaf's path, shape, dtype
        shard_h000.npz       <- the leaves as a0, a1, ... in sorted-key order
      step_000000123.tmp-*/  <- a write in flight (never read)
      LATEST                 <- the newest published step, written last

A leaf's path is its ``jax.tree_util.keystr`` spelling
(``['params']['layers']['wq']``), so either package reads what the other
wrote.  A bf16 leaf is stored as its 2-byte pattern (``|V2``, what
``np.savez`` writes for the JAX package's ``ml_dtypes`` bfloat16) with
``bfloat16`` as the manifest's dtype; a restore reads it back through a
2-byte integer view, so no ``ml_dtypes`` is needed.

The publishing rules are the reference's: a writer never touches a
published directory (a crash leaves only a ``.tmp-*`` directory, which
restore skips and :func:`gc_tmp` removes); :func:`restore_latest` walks
the published steps newest first and skips a torn one.  Restored leaves
are CPU tensors; :func:`reshard_restore` places them on devices or on a
mesh.  A :class:`~repro_torch.dist.sharding.Sharded` leaf (a training
program on a mesh) is written whole, as the JAX package writes a global
array, so a checkpoint written on one mesh restores onto any other, onto
one device, or into the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Sharded
from repro_torch.tree import build, keystr, leaves, tree_map


def _host_array(x) -> np.ndarray:
    """A leaf as the numpy array ``np.savez`` stores (bf16 as ``|V2``)."""
    if isinstance(x, Sharded):
        x = x.unshard(device="cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, (torch.Tensor, Sharded)):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype."""
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"a {dtype} leaf stored as {a.dtype}")
    return torch.from_numpy(np.array(a))


def save(ckpt_dir: str, step: int, state) -> str:
    """Write and atomically publish one checkpoint; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp-", dir=ckpt_dir)
    try:
        flat = list(leaves(state))
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": [{"path": keystr(p), "shape": list(np.shape(_host_array(x))),
                        "dtype": _dtype_name(x)} for p, x in flat],
        }
        arrays = {f"a{i}": _host_array(x) for i, (_, x) in enumerate(flat)}
        np.savez(os.path.join(tmp, "shard_h000.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        try:
            os.replace(tmp, final)  # atomic publish
        except OSError:
            if os.path.isdir(final):  # the same step already published: idempotent
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return final


def published_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and ".tmp" not in d:
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def gc_tmp(ckpt_dir: str) -> int:
    """Remove the in-flight writes of a crashed run; returns their count."""
    n = 0
    if not os.path.isdir(ckpt_dir):
        return 0
    for d in os.listdir(ckpt_dir):
        if ".tmp" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
            n += 1
    return n


def restore(ckpt_dir: str, step: int, like):
    """The checkpoint of ``step`` in the structure of ``like`` (paths,
    shapes validated), as CPU tensors of the stored dtypes; -> (tree,
    step)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    entries = manifest["leaves"]
    with np.load(os.path.join(path, "shard_h000.npz")) as z:
        arrays = [z[f"a{i}"] for i in range(len(entries))]
    flat_like = list(leaves(like))
    if len(flat_like) != len(arrays):
        raise ValueError(f"tree structure changed: {len(arrays)} leaves stored, "
                         f"{len(flat_like)} wanted")
    out = []
    for a, entry, (p, leaf) in zip(arrays, entries, flat_like):
        if entry["path"] != keystr(p):
            raise ValueError(f"leaf {entry['path']} stored where {keystr(p)} is wanted")
        want = tuple(leaf.shape) if isinstance(leaf, Sharded) else tuple(np.shape(leaf))
        if tuple(a.shape) != want:
            raise ValueError(f"shape mismatch {a.shape} vs {want} at {entry['path']}")
        out.append((p, _tensor(a, entry["dtype"])))
    return build(out), manifest["step"]


def restore_latest(ckpt_dir: str, like):
    """The newest readable checkpoint, skipping torn ones; None if none."""
    for step in reversed(published_steps(ckpt_dir)):
        try:
            return restore(ckpt_dir, step, like)
        except Exception:
            continue
    return None


def _put(x: torch.Tensor, where, mesh):
    if mesh is not None:  # a partition spec on ``mesh``
        return shd.shard(x, mesh, where)
    if isinstance(where, Sharded):  # laid out as that leaf
        return shd.shard(x.to(where.mesh.lead), where.mesh, where.spec)
    if isinstance(where, torch.Tensor):
        where = where.device
    return x.to(where)


def place(tree, where, mesh=None):
    """``tree``'s leaves placed by ``where``: one device (or its name) for
    every leaf, or a tree whose leaves are devices, tensors (their device)
    or :class:`Sharded` (split as they are); with ``mesh``, a tree of
    partition specs (``spec_for``'s, as ``Program.in_shardings`` holds),
    each leaf split by its spec over ``mesh``."""
    if isinstance(where, dict):
        return tree_map(lambda x, w: _put(x, w, mesh), tree, where)
    return tree_map(lambda x: _put(x, where, mesh), tree)


def reshard_restore(ckpt_dir: str, step: int, like, where, mesh=None):
    """Restore onto new devices or a new mesh: the stored arrays are whole,
    so this is :func:`restore` then :func:`place` by ``where`` (and
    ``mesh``)."""
    state, s = restore(ckpt_dir, step, like)
    return place(state, where, mesh), s
