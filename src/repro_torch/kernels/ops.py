"""One wrapper per kernel: the only doors from the engine to ``csrc/``.

A wrapper checks device, dtype, shape and contiguity, allocates outputs
and scratch with ``torch.empty``, launches on the current stream, raises
if the launch reports an error, and counts the launch in ``LAUNCHES``.
Tensors on the CPU take the kernel's plain version in ``kernels/ref.py``
instead; that is the only case in which a plain version runs.  Nothing
here synchronises with the device.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.k2tree import K2Meta
from repro_torch.kernels import build, ref

LAUNCHES = {"k2_scan": 0, "k2_check": 0, "pred_gather_dac": 0}
_count_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_IA = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "k2_check": ("k2_check_launch", [
        _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _IA, _IA, _I,
        _P, _P, _I,
    ]),
    "k2_scan": ("k2_scan_launch", [
        _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _IA, _IA, _I,
        _I, _P, _P, _P, _P, _P, _P, _I,
    ]),
    "pred_gather_dac": ("pred_gather_dac_launch", [
        _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _IA, _IA, _I, _I,
        _I, _P, _P, _P, _P, _P, _I,
    ]),
}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _fns.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, stream, device.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES[name] += 1


def _ints(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int * max(len(values), 1))(*values)


def _check_tensors(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_lanes(*lanes: torch.Tensor) -> int:
    q = lanes[0].shape[0]
    for t in lanes:
        if t.dim() != 1 or t.shape[0] != q:
            raise ValueError(f"lane arrays must be 1-D of one length, got {[tuple(x.shape) for x in lanes]}")
    return q


def _check_forest(meta: K2Meta, f) -> None:
    H = meta.n_levels
    if H > 32:
        raise ValueError(f"trees of {H} levels exceed the kernels' limit of 32")
    p = f.t_words.shape[0]
    shapes = {
        "t_words": (p, f.t_words.shape[1]), "t_rank": (p, f.t_words.shape[1]),
        "l_words": (p, f.l_words.shape[1]), "ones_before": (p, max(H - 1, 1)),
        "level_start": (p, H),
    }
    for name, shape in shapes.items():
        if tuple(getattr(f, name).shape) != shape:
            raise ValueError(f"forest {name} has shape {tuple(getattr(f, name).shape)}, want {shape}")
    if p < 1:
        raise ValueError("forest holds no tree")


def _forest_args(meta: K2Meta, f):
    return (
        f.t_words.data_ptr(), f.t_rank.data_ptr(), f.l_words.data_ptr(),
        f.ones_before.data_ptr(), f.level_start.data_ptr(),
        f.t_words.shape[0], f.t_words.shape[1], f.l_words.shape[1],
        f.ones_before.shape[1], _ints(meta.ks), _ints(meta.subsides),
        meta.n_levels,
    )


def _forest_tensors(f) -> dict:
    return dict(t_words=f.t_words, t_rank=f.t_rank, l_words=f.l_words,
                ones_before=f.ones_before, level_start=f.level_start)


def k2_check(meta: K2Meta, f, preds, rows, cols) -> torch.Tensor:
    """Batched (S, P, O) probe over the forest -> bool[Q] (``csrc/k2_check.cu``)."""
    dev = preds.device
    _check_tensors(dev, preds=preds, rows=rows, cols=cols, **_forest_tensors(f))
    q = _check_lanes(preds, rows, cols)
    _check_forest(meta, f)
    if dev.type == "cpu":
        return ref.k2_check_ref(
            meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
            f.level_start, preds, rows, cols,
        )
    out = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        _launch("k2_check", dev, preds.data_ptr(), rows.data_ptr(),
                cols.data_ptr(), q, *_forest_args(meta, f), out.data_ptr())
    return out


def k2_scan(meta: K2Meta, f, preds, keys, axes, *, cap: int):
    """Batched mixed row/col scan -> (ids, valid, count, overflow)
    (``csrc/k2_scan.cu``)."""
    dev = preds.device
    _check_tensors(dev, preds=preds, keys=keys, axes=axes, **_forest_tensors(f))
    q = _check_lanes(preds, keys, axes)
    _check_forest(meta, f)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if dev.type == "cpu":
        return ref.k2_scan_ref(
            meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
            f.level_start, preds, keys, axes, cap=cap,
        )
    ids = torch.empty((q, cap), dtype=torch.int32, device=dev)
    valid = torch.empty((q, cap), dtype=torch.bool, device=dev)
    count = torch.empty(q, dtype=torch.int32, device=dev)
    overflow = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        scratch = torch.empty((4, q, cap), dtype=torch.int32, device=dev)
        _launch("k2_scan", dev, preds.data_ptr(), keys.data_ptr(),
                axes.data_ptr(), q, *_forest_args(meta, f), cap,
                scratch.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                count.data_ptr(), overflow.data_ptr())
    return ids, valid, count, overflow


def pred_gather_dac(pmeta, index, rows, *, cap: int):
    """DAC(b=8) candidate-predicate decode -> (ids, valid, count, overflow)
    (``csrc/pred_gather_dac.cu``).  ``rows`` must be clipped to the index."""
    dev = rows.device
    _check_tensors(dev, rows=rows, anchors=index.offsets, words=index.words,
                   degs=index.degs, flags=index.flags, frank=index.frank)
    q = _check_lanes(rows)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if pmeta.layout != "dac":
        raise ValueError(f"index layout is {pmeta.layout!r}, not 'dac'")
    if dev.type == "cpu":
        return ref.pred_gather_dac_ref(
            rows, index.offsets, index.words, index.degs, index.flags,
            index.frank, levels=pmeta.levels,
            level_byte_start=pmeta.level_byte_start,
            flag_word_start=pmeta.flag_word_start, deg_width=pmeta.deg_width,
            rows_per_block=pmeta.rows_per_block, cap=cap,
        )
    ids = torch.empty((q, cap), dtype=torch.int32, device=dev)
    valid = torch.empty((q, cap), dtype=torch.bool, device=dev)
    count = torch.empty(q, dtype=torch.int32, device=dev)
    overflow = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        _launch("pred_gather_dac", dev, rows.data_ptr(), q,
                index.offsets.data_ptr(), index.offsets.shape[0],
                index.words.data_ptr(), index.words.shape[0],
                index.degs.data_ptr(), index.degs.shape[0],
                index.flags.data_ptr(), index.flags.shape[0],
                index.frank.data_ptr(), pmeta.levels,
                _ints(pmeta.level_byte_start), _ints(pmeta.flag_word_start),
                pmeta.deg_width, pmeta.rows_per_block, cap, ids.data_ptr(),
                valid.data_ptr(), count.data_ptr(), overflow.data_ptr())
    return ids, valid, count, overflow


def pred_gather(pmeta, index, rows, *, cap: int):
    """Fixed-layout candidate gather: plain version only, CPU only."""
    if rows.device.type != "cpu":
        raise NotImplementedError(
            "pred_index_layout='fixed' has no CUDA kernel yet (ROADMAP Queue 2, "
            "kernels/pred_gather.py::pred_gather); use the default 'dac' layout"
        )
    _check_tensors(rows.device, rows=rows, offsets=index.offsets, words=index.words)
    _check_lanes(rows)
    return ref.pred_gather_ref(
        rows, index.offsets, index.words,
        bytes_per_pred=pmeta.bytes_per_pred, cap=cap,
    )
