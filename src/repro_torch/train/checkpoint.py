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
are CPU tensors; :func:`reshard_restore` places them on devices.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.tree import build, keystr, leaves, tree_map


def _host_array(x) -> np.ndarray:
    """A leaf as the numpy array ``np.savez`` stores (bf16 as ``|V2``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
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
        if tuple(a.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch {a.shape} vs {tuple(np.shape(leaf))} at {entry['path']}")
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


def place(tree, devices):
    """``tree``'s leaves on ``devices``: one ``torch.device`` (or its
    name) for every leaf, or a tree of them."""
    if isinstance(devices, dict):
        return tree_map(lambda x, d: x.to(d), tree, devices)
    return tree_map(lambda x: x.to(devices), tree)


def reshard_restore(ckpt_dir: str, step: int, like, devices):
    """Restore onto new devices: the stored arrays are whole, so a restore
    onto another device (or a tree of them) is :func:`restore` then
    :func:`place`."""
    state, s = restore(ckpt_dir, step, like)
    return place(state, devices), s
