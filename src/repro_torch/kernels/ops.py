"""One wrapper per kernel: the only doors from the engine to ``csrc/``.

A wrapper checks device, dtype, shape and contiguity, allocates outputs
and scratch with ``torch.empty``, launches on the current stream, raises
if the launch reports an error, and counts the launch in ``LAUNCHES``.
Tensors on the CPU take the kernel's plain version in ``kernels/ref.py``
instead; that is the only case in which a plain version runs.  Nothing
here synchronises with the device.

``k2_check_tree`` (the single-tree check, ``k2_check`` at P = 1) and the
last three entry points (``popcount``, ``sorted_intersect_mask``,
``block_spmm``) keep the JAX package's ``repro.kernels.ops`` functions of
the same names and shape contracts; no query path calls the last three.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core.k2tree import K2Meta
from repro_torch.kernels import build, ref

LAUNCHES = {
    "k2_scan": 0, "k2_check": 0, "pred_gather_dac": 0,
    "pred_gather": 0, "k2_range": 0, "k2_scan_rebind": 0,
    "popcount": 0, "sorted_intersect_mask": 0, "block_spmm": 0,
}
_count_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_IA = ctypes.POINTER(ctypes.c_int)
_FOREST = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _IA, _IA, _I]  # _forest_args
_SIGNATURES = {
    "k2_check": ("k2_check_launch", [_P, _P, _P, _I, *_FOREST, _I, _I, _I, _P, _P, _I]),
    "k2_scan": ("k2_scan_launch", [
        _P, _P, _P, _I, *_FOREST, _I, _I, _P, _LL, _P, _P, _P, _P, _P, _I,
    ]),
    "pred_gather_dac": ("pred_gather_dac_launch", [
        _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _IA, _IA, _I, _I,
        _I, _I, _I, _P, _P, _P, _P, _P, _I,
    ]),
    "pred_gather": ("pred_gather_launch", [
        _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
    ]),
    "k2_range": ("k2_range_launch", [
        _P, _I, *_FOREST, _I, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _I,
    ]),
    "k2_scan_rebind": ("k2_scan_rebind_launch", [
        _P, _P, _P, _P, _P, _I, *_FOREST, _I, _I, _I, _I, _P, _LL,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
    ]),
    "popcount": ("popcount_launch", [_P, _LL, _P, _P, _I]),
    "sorted_intersect_mask": ("sorted_intersect_launch", [
        _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I,
    ]),
    "block_spmm": ("block_spmm_launch", [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I,
    ]),
}
# the Pallas kernels' shape contracts at their default blocks
LANES = 128  # popcount: lanes a row (the TPU vreg width)
POPCOUNT_ROWS = 8  # popcount: rows % 8
INTERSECT_LANES = 2048  # sorted_intersect_mask: ca % min(2048, ca)
INTERSECT_WINDOW = 4096  # sorted_intersect_mask: ids of B a tile stages (16 KB)
INTERSECT_TILE = 1024  # sorted_intersect_mask: A lanes a tile (4 a thread)
_SPMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# block_spmm's kernels (csrc/block_spmm.cu): wgmma output tiles, largest first
_SPMM_CODES = {"simt": 0, "fma": 1, "wgmma": 2}
_WGMMA_TILES = ((128, 256), (128, 128), (64, 256), (64, 128), (64, 64))
_SIMT = ("simt", 128, 128, 16, 256)


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _c_fn(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of kernel ``name``'s library, typed (built on first use)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[symbol] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _c_fn(name, *_SIGNATURES[name])
    stream = torch.cuda.current_stream(device).cuda_stream
    # the library selects ``device`` itself; the guard gives the caller
    # back its current device (a mesh launches on several cards)
    with torch.cuda.device(device):
        err = fn(*args, stream, device.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES[name] += 1


def _ints(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int * max(len(values), 1))(*values)


def _check_tensors(device: torch.device, *, dtypes=(torch.int32,), **tensors) -> None:
    from repro_torch.core.query import meta_allowed

    if device.type not in ("cuda", "cpu") and not (device.type == "meta" and meta_allowed()):
        raise ValueError(f"kernels run on a CUDA card or the CPU, not on {device}")
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
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


def _on_meta(inputs, outputs):
    """A wrapper's call on ``meta`` tensors (the dry run): its outputs'
    static shapes, no launch; its bytes go to any flop count in progress
    (an opaque kernel, as the reference counts a ``pallas_call``)."""
    from repro_torch.launch import flopcount

    flopcount.opaque(inputs, outputs)
    return outputs


def _outputs(dev: torch.device, shape: tuple):
    """(ids int32, valid bool) of ``shape`` and (count int32, overflow bool)
    of ``shape[:-1]``: the output block of a scan-like kernel."""
    return (
        torch.empty(shape, dtype=torch.int32, device=dev),
        torch.empty(shape, dtype=torch.bool, device=dev),
        torch.empty(shape[:-1], dtype=torch.int32, device=dev),
        torch.empty(shape[:-1], dtype=torch.bool, device=dev),
    )


def _scan_grid(name: str, device: torch.device, lanes: int, cap: int) -> tuple[int, int]:
    """(blocks, spill ints) of one launch of the warp-per-lane scan kernel
    (``csrc/k2_scan_lane.cuh``) in library ``name`` over ``lanes`` lanes."""
    with torch.cuda.device(device):  # the query selects ``device``
        blocks = _c_fn(name, f"{name}_blocks", [_LL, _I])(lanes, device.index)
    if blocks < 1:
        raise RuntimeError(f"{name}: no grid for {lanes} lanes: CUDA error {-blocks}")
    return blocks, _c_fn(name, f"{name}_spill_ints", [_I, _I], _LL)(blocks, cap)


def _warp_lane_grid(lanes: int, sms: int) -> tuple[int, int]:
    """(blocks, threads a block) of a launch of one warp a lane
    (``csrc/pred_gather_dac.cu``, small ``k2_check`` batches): 1 to 4 warps
    a block, as few as spread the lanes over all ``sms`` multiprocessors."""
    warps = min(4, max(1, lanes // sms))
    return -(-lanes // warps), 32 * warps


def _check_grid(lanes: int, sms: int) -> tuple[int, int, int]:
    """(kernel, blocks, threads a block) of a ``k2_check`` launch
    (``csrc/k2_check.cu``): one warp a lane (kernel 0, ``_warp_lane_grid``)
    while the lanes come to at most 8 warps an SM, else one thread a lane
    (kernel 1) in blocks of 128."""
    if lanes <= 8 * sms:
        return (0, *_warp_lane_grid(lanes, sms))
    return 1, -(-lanes // 128), 128


def _intersect_plan(ca: int, cb: int, sms: int) -> tuple[int, int, int, int]:
    """(kernel, threads a block, blocks, window) of a
    ``sorted_intersect_mask`` launch (``csrc/sorted_intersect.cu``).

    Kernel 1 takes a thread a lane in blocks of 256: while the lanes come
    to at most ``INTERSECT_TILE`` for each of the ``sms`` multiprocessors
    (a launch short enough that its time is latency), and where a tile's
    even share of B (``INTERSECT_TILE · cb / ca``) would exceed the window.
    Else kernel 0 takes tiles of ``INTERSECT_TILE`` lanes, 4 a thread, and
    stages in shared memory all of B up to ``INTERSECT_WINDOW`` ids, else a
    window of that many."""
    if ca <= INTERSECT_TILE * sms or INTERSECT_TILE * cb > INTERSECT_WINDOW * ca:
        return 1, 256, -(-ca // 256), 0
    return 0, INTERSECT_TILE // 4, -(-ca // INTERSECT_TILE), min(cb, INTERSECT_WINDOW)


def k2_check(meta: K2Meta, f, preds, rows, cols) -> torch.Tensor:
    """Batched (S, P, O) probe over the forest -> bool[Q] (``csrc/k2_check.cu``)."""
    dev = preds.device
    _check_tensors(dev, preds=preds, rows=rows, cols=cols, **_forest_tensors(f))
    q = _check_lanes(preds, rows, cols)
    _check_forest(meta, f)
    if dev.type == "meta":
        return _on_meta((preds, rows, cols, _forest_tensors(f)),
                        torch.empty(q, dtype=torch.bool, device=dev))
    if dev.type == "cpu":
        return ref.k2_check_ref(
            meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
            f.level_start, preds, rows, cols,
        )
    out = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        _launch("k2_check", dev, preds.data_ptr(), rows.data_ptr(),
                cols.data_ptr(), q, *_forest_args(meta, f),
                *_check_grid(q, _sm_count(dev)), out.data_ptr())
    return out


def k2_check_tree(meta: K2Meta, tree, rows, cols) -> torch.Tensor:
    """Batched (S, P, O) probe of one ``K2Tree`` -> bool[Q]: ``k2_check``
    over the tree as the one-tree forest, every lane's predicate 0."""
    from repro_torch.core import k2forest

    return k2_check(meta, k2forest.of_tree(tree), torch.zeros_like(rows), rows, cols)


def k2_scan(meta: K2Meta, f, preds, keys, axes, *, cap: int):
    """Batched mixed row/col scan -> (ids, valid, count, overflow)
    (``csrc/k2_scan.cu``)."""
    dev = preds.device
    _check_tensors(dev, preds=preds, keys=keys, axes=axes, **_forest_tensors(f))
    q = _check_lanes(preds, keys, axes)
    _check_forest(meta, f)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if dev.type == "meta":
        return _on_meta((preds, keys, axes, _forest_tensors(f)), _outputs(dev, (q, cap)))
    if dev.type == "cpu":
        return ref.k2_scan_ref(
            meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
            f.level_start, preds, keys, axes, cap=cap,
        )
    ids, valid, count, overflow = _outputs(dev, (q, cap))
    if q:
        blocks, spill = _scan_grid("k2_scan", dev, q, cap)
        scratch = torch.empty(max(spill, 1), dtype=torch.int32, device=dev)
        _launch("k2_scan", dev, preds.data_ptr(), keys.data_ptr(),
                axes.data_ptr(), q, *_forest_args(meta, f), cap, blocks,
                scratch.data_ptr(), spill, ids.data_ptr(), valid.data_ptr(),
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
    if dev.type == "meta":
        return _on_meta((rows, index.offsets, index.words, index.degs, index.flags, index.frank),
                        _outputs(dev, (q, cap)))
    if dev.type == "cpu":
        return ref.pred_gather_dac_ref(
            rows, index.offsets, index.words, index.degs, index.flags,
            index.frank, levels=pmeta.levels,
            level_byte_start=pmeta.level_byte_start,
            flag_word_start=pmeta.flag_word_start, deg_width=pmeta.deg_width,
            rows_per_block=pmeta.rows_per_block, cap=cap,
        )
    ids, valid, count, overflow = _outputs(dev, (q, cap))
    if q:
        _launch("pred_gather_dac", dev, rows.data_ptr(), q,
                index.offsets.data_ptr(), index.offsets.shape[0],
                index.words.data_ptr(), index.words.shape[0],
                index.degs.data_ptr(), index.degs.shape[0],
                index.flags.data_ptr(), index.flags.shape[0],
                index.frank.data_ptr(), pmeta.levels,
                _ints(pmeta.level_byte_start), _ints(pmeta.flag_word_start),
                pmeta.deg_width, pmeta.rows_per_block, cap,
                *_warp_lane_grid(q, _sm_count(dev)), ids.data_ptr(),
                valid.data_ptr(), count.data_ptr(), overflow.data_ptr())
    return ids, valid, count, overflow


def pred_gather(pmeta, index, rows, *, cap: int):
    """Fixed-layout candidate-predicate gather -> (ids, valid, count,
    overflow) (``csrc/pred_gather.cu``).  ``rows`` must be clipped to the
    index."""
    dev = rows.device
    _check_tensors(dev, rows=rows, offsets=index.offsets, words=index.words)
    q = _check_lanes(rows)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if pmeta.layout != "fixed":
        raise ValueError(f"index layout is {pmeta.layout!r}, not 'fixed'")
    if pmeta.bytes_per_pred not in (1, 2, 4):
        raise ValueError(f"bytes_per_pred must be 1, 2 or 4, got {pmeta.bytes_per_pred}")
    if index.offsets.dim() != 1 or index.offsets.shape[0] < 2 or index.words.dim() != 1:
        raise ValueError("offsets must be 1-D CSR pointers of >= 2 entries, words 1-D")
    if dev.type == "meta":
        return _on_meta((rows, index.offsets, index.words), _outputs(dev, (q, cap)))
    if dev.type == "cpu":
        return ref.pred_gather_ref(
            rows, index.offsets, index.words,
            bytes_per_pred=pmeta.bytes_per_pred, cap=cap,
        )
    ids, valid, count, overflow = _outputs(dev, (q, cap))
    if q:
        _launch("pred_gather", dev, rows.data_ptr(), q, index.offsets.data_ptr(),
                index.offsets.shape[0], index.words.data_ptr(),
                index.words.shape[0], pmeta.bytes_per_pred, cap,
                ids.data_ptr(), valid.data_ptr(), count.data_ptr(),
                overflow.data_ptr())
    return ids, valid, count, overflow


def k2_range(meta: K2Meta, f, preds, *, cap: int):
    """Batched (?S, P, ?O) pair enumeration -> (rows, cols, valid, count,
    overflow) (``csrc/k2_range.cu``)."""
    dev = preds.device
    _check_tensors(dev, preds=preds, **_forest_tensors(f))
    q = _check_lanes(preds)
    _check_forest(meta, f)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if dev.type == "meta":
        return _on_meta((preds, _forest_tensors(f)),
                        (torch.empty((q, cap), dtype=torch.int32, device=dev),
                         *_outputs(dev, (q, cap))))
    if dev.type == "cpu":
        return ref.k2_range_ref(
            meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
            f.level_start, preds, cap=cap,
        )
    rows = torch.empty((q, cap), dtype=torch.int32, device=dev)
    cols, valid, count, overflow = _outputs(dev, (q, cap))
    if q:
        # the frontier (6·cap ints a lane) and the level counters beside it
        scratch = torch.empty((6, q, cap), dtype=torch.int32, device=dev)
        n_counters = _c_fn("k2_range", "k2_range_counter_ints", [_I, _I], _LL)(q, cap)
        counters = torch.empty(n_counters, dtype=torch.int32, device=dev)
        _launch("k2_range", dev, preds.data_ptr(), q, *_forest_args(meta, f),
                cap, scratch.data_ptr(), counters.data_ptr(), n_counters,
                rows.data_ptr(), cols.data_ptr(), valid.data_ptr(),
                count.data_ptr(), overflow.data_ptr())
    return rows, cols, valid, count, overflow


def k2_scan_rebind(meta: K2Meta, f, preds1, keys1, axes1, preds2, axes2, *,
                   cap_x: int, cap_y: int):
    """Scan -> re-bind (join categories D, E) -> ``(x_ids, x_valid, x_count,
    x_overflow, y_ids, y_valid, y_count, y_overflow)`` shaped ``(Q,cap_x)
    ×2, (Q,) ×2, (Q,cap_x,cap_y) ×2, (Q,cap_x) ×2``
    (``csrc/k2_scan_rebind.cu``, one launch of two queued kernels)."""
    dev = preds1.device
    _check_tensors(dev, preds1=preds1, keys1=keys1, axes1=axes1, preds2=preds2,
                   axes2=axes2, **_forest_tensors(f))
    q = _check_lanes(preds1, keys1, axes1, preds2, axes2)
    _check_forest(meta, f)
    if cap_x < 1 or cap_y < 1:
        raise ValueError(f"cap_x and cap_y must be >= 1, got {cap_x}, {cap_y}")
    if dev.type == "meta":
        return _on_meta((preds1, keys1, axes1, preds2, axes2, _forest_tensors(f)),
                        _outputs(dev, (q, cap_x)) + _outputs(dev, (q, cap_x, cap_y)))
    if dev.type == "cpu":
        return ref.k2_scan_rebind_ref(
            meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
            f.level_start, preds1, keys1, axes1, preds2, axes2,
            cap_x=cap_x, cap_y=cap_y,
        )
    if q * cap_x > 2**31 - 1:
        raise ValueError(f"{q} query lanes x cap_x {cap_x} exceed 2^31 - 1 Y lanes")
    x = _outputs(dev, (q, cap_x))
    y = _outputs(dev, (q, cap_x, cap_y))
    if q:
        # the X scans and each query lane's key-0 scan, then the Y lanes
        blocks_x, spill_x = _scan_grid("k2_scan_rebind", dev, 2 * q, max(cap_x, cap_y))
        blocks_y, spill_y = _scan_grid("k2_scan_rebind", dev, q * cap_x, cap_y)
        spill = max(spill_x, spill_y)  # the phases run one after the other
        scratch = torch.empty(max(spill, 1), dtype=torch.int32, device=dev)
        zero = _outputs(dev, (q, cap_y))  # each query lane's key-0 scan
        _launch("k2_scan_rebind", dev, preds1.data_ptr(), keys1.data_ptr(),
                axes1.data_ptr(), preds2.data_ptr(), axes2.data_ptr(), q,
                *_forest_args(meta, f), cap_x, cap_y, blocks_x, blocks_y,
                scratch.data_ptr(), spill, *(t.data_ptr() for t in x + zero + y))
    return x + y


def popcount(words) -> torch.Tensor:
    """Set bits of every word of a ``(M, 128·k)`` arena of int32 words
    carrying uint32 bits -> int32 of the same shape (``csrc/popcount.cu``).
    ``M`` must be a multiple of 8, as for the Pallas kernel at its default
    block."""
    dev = words.device
    _check_tensors(dev, words=words)
    if words.dim() != 2:
        raise ValueError(f"words must be 2-D, got shape {tuple(words.shape)}")
    m, n = words.shape
    if n % LANES:
        raise ValueError(f"lane dim must be a multiple of {LANES}, got {n}")
    if m % POPCOUNT_ROWS:
        raise ValueError(f"rows {m} not divisible by {POPCOUNT_ROWS}")
    if dev.type == "meta":
        return _on_meta(words, torch.empty((m, n), dtype=torch.int32, device=dev))
    if dev.type == "cpu":
        return ref.popcount_ref(words)
    if words.data_ptr() % 16:
        words = words.clone()  # the kernel moves 16 bytes a thread
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if out.numel():
        _launch("popcount", dev, words.data_ptr(), out.numel(), out.data_ptr())
    return out


def sorted_intersect_mask(a_ids, b_ids) -> torch.Tensor:
    """``mask[i] = a_ids[i] ∈ b_ids`` -> bool[ca], both ascending int32 and
    ``SENTINEL``-padded (``csrc/sorted_intersect.cu``).  ``ca`` must be a
    multiple of ``min(2048, ca)``, as for the Pallas kernel."""
    dev = a_ids.device
    _check_tensors(dev, a_ids=a_ids, b_ids=b_ids)
    if a_ids.dim() != 1 or b_ids.dim() != 1:
        raise ValueError(f"id lists must be 1-D, got {tuple(a_ids.shape)}, {tuple(b_ids.shape)}")
    ca, cb = a_ids.shape[0], b_ids.shape[0]
    block = min(INTERSECT_LANES, ca)
    if block < 1 or ca % block:
        raise ValueError(f"{ca} A lanes do not split into blocks of {block}")
    if cb < 1:
        raise ValueError("b_ids is empty")
    if dev.type == "meta":
        return _on_meta((a_ids, b_ids), torch.empty(ca, dtype=torch.bool, device=dev))
    if dev.type == "cpu":
        return ref.sorted_intersect_mask_ref(a_ids, b_ids)
    out = torch.empty(ca, dtype=torch.bool, device=dev)
    _launch("sorted_intersect_mask", dev, a_ids.data_ptr(), ca, b_ids.data_ptr(),
            cb, out.data_ptr(), *_intersect_plan(ca, cb, _sm_count(dev)))
    return out


def _spmm_variant(m: int, k: int, d: int, bm: int, bk: int, bd: int, dtype,
                  aligned: bool, sms: int) -> tuple[str, int, int, int, int]:
    """The kernel of ``csrc/block_spmm.cu`` that serves these shapes, as
    ``(name, tile rows, tile columns, k chunk, threads a block)``.

    Both fast kernels need A and X 16-byte aligned and BK a multiple of 16;
    every output tile must lie in one mask row.  bf16 takes ``wgmma``: the
    largest tile (rows dividing BM, columns dividing D) whose block count
    reaches 3/4 of the ``sms`` multiprocessors, else the one with the most
    blocks; k chunks of 64, or 16 when BK is not a multiple of 64.  f32
    takes ``fma`` when BM and D are multiples of 64: 64 threads of 8 x 8
    sums when the grid gives every SM four blocks, else 256 threads of
    4 x 4; k chunks of 32, or 16.  Everything else takes ``simt``.
    """
    del k, bd  # any K, and any BD dividing D, suit every kernel
    if not aligned or bk % 16:
        return _SIMT
    if dtype == torch.bfloat16:
        fits = [(tm, tn) for tm, tn in _WGMMA_TILES if bm % tm == 0 and d % tn == 0]
        if not fits:
            return _SIMT
        tm, tn = next((t for t in fits if 4 * (m // t[0]) * (d // t[1]) >= 3 * sms), fits[-1])
        return "wgmma", tm, tn, 64 if bk % 64 == 0 else 16, 2 * tm + 32
    if bm % 64 or d % 64:
        return _SIMT
    blocks = (m // 64) * (d // 64)
    return "fma", 64, 64, 32 if bk % 32 == 0 else 16, 64 if blocks >= 4 * sms else 256


def block_spmm_variant(a, x, *, block_m: int = 128, block_k: int = 128,
                       block_d: int = 128) -> tuple[str, int, int, int, int]:
    """``_spmm_variant`` for these CUDA operands: what ``block_spmm`` launches."""
    (m, k), d = a.shape, x.shape[1]
    aligned = a.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    return _spmm_variant(m, k, d, block_m, block_k, block_d, a.dtype, aligned,
                         _sm_count(a.device))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_spmm(mask, a, x, *, block_m: int = 128, block_k: int = 128,
               block_d: int = 128) -> torch.Tensor:
    """``Y = A @ X`` in f32, skipping A's ``(block_m, block_k)`` tiles whose
    int32 ``mask`` entry is 0 (``csrc/block_spmm.cu``; the kernel and tile
    from ``block_spmm_variant``).  A and X are both f32 or both bf16; a
    masked-off tile is never read."""
    dev = a.device
    _check_tensors(dev, mask=mask)
    _check_tensors(dev, dtypes=tuple(_SPMM_DTYPES), a=a, x=x)
    if a.dtype != x.dtype:
        raise TypeError(f"a and x must share a dtype, got {a.dtype} and {x.dtype}")
    if a.dim() != 2 or x.dim() != 2 or a.shape[1] != x.shape[0]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by {tuple(x.shape)}")
    (m, k), d = a.shape, x.shape[1]
    if min(block_m, block_k, block_d) < 1 or m % block_m or k % block_k or d % block_d:
        raise ValueError(f"blocks ({block_m}, {block_k}, {block_d}) do not divide "
                         f"(M, K, D) = ({m}, {k}, {d})")
    if tuple(mask.shape) != (m // block_m, k // block_k):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, want {(m // block_m, k // block_k)}")
    if dev.type == "meta":
        return _on_meta((mask, a, x), torch.empty((m, d), dtype=torch.float32, device=dev))
    if dev.type == "cpu":
        return ref.block_spmm_ref(mask, a, x, block_m, block_k)
    if k == 0:
        return torch.zeros((m, d), dtype=torch.float32, device=dev)
    y = torch.empty((m, d), dtype=torch.float32, device=dev)
    if y.numel():
        name, *tiling = block_spmm_variant(
            a, x, block_m=block_m, block_k=block_k, block_d=block_d)
        _launch("block_spmm", dev, mask.data_ptr(), a.data_ptr(), x.data_ptr(),
                _SPMM_DTYPES[a.dtype], m, k, d, block_m, block_k, block_d,
                _SPMM_CODES[name], *tiling, y.data_ptr())
    return y
