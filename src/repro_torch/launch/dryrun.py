"""Dry run: build every (arch x shape x mesh) cell and run it once on the
``meta`` device, with no card and no memory.

For each cell this shows, without hardware:
  * the program builds and runs on the mesh (every layout and collective
    is exercised on tensors that hold shapes only),
  * how many flops and bytes it does (``flopcount``), what its
    collectives move (``dist.collectives.WIRE``) and the three roofline
    terms of an H100 SXM (``roofline``),
  * and its peak memory (``peak_mem_bytes``): the most bytes that live
    ``meta`` tensors held at once during the run, the arguments included.
    On (1, 1) that is one card's; a mesh's positions share the one ``meta``
    device, so on a mesh it is the whole mesh's, a replicated value held
    once.

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh 1x1 --mesh 2x4]
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch --jobs 6

A mesh (1, 1) is one card, (2, 4) one 8-card node; both are meshes of
``meta`` devices.  One JSON file a cell is written, so a crashed sweep
resumes where it left off (``--force`` runs it again); the command exits 1
if any cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DEFAULT_MESHES = ((1, 1), (2, 4))


def _storages(x):
    """The tensors in ``x`` (nested sequences, dicts, ``Sharded`` values and
    dataclasses such as ``K2Forest``)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _storages(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _storages(v)
    elif hasattr(x, "parts"):  # a Sharded value
        yield from _storages(x.parts)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        yield from _storages([getattr(x, f.name) for f in dataclasses.fields(x)])


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes live storages hold while it is on: every
    storage an op makes (and every one passed to :meth:`hold`) counts from
    then until only this mode still refers to it.  The exact live total is
    taken only when a new storage could raise the peak.  With a ``cost``
    it also counts each op (``flopcount.tally``; one mode, not two)."""

    def __init__(self, cost=None):
        super().__init__()
        self.cost = cost
        self.held: dict[int, tuple] = {}  # cdata -> (storage, nbytes)
        self.upper = 0  # >= the live bytes (frees found at the next sweep)
        self.peak = 0

    def _sweep(self) -> None:
        use = torch._C._storage_Use_Count
        for cd in [cd for cd, (s, _) in self.held.items() if use(cd) <= 1]:
            del self.held[cd]
        self.upper = sum(nb for _, nb in self.held.values())

    def hold(self, x) -> None:
        for t in _storages(x):
            if t.layout != torch.strided:
                continue
            s = t.untyped_storage()
            cd = s._cdata
            if cd in self.held:
                continue
            nb = s.nbytes()
            if self.upper + nb > self.peak:
                self._sweep()
            self.held[cd] = (s, nb)
            self.upper += nb
            self.peak = max(self.peak, self.upper)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_on_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        self.hold(out)
        if self.cost is not None:
            from repro_torch.launch import flopcount

            flopcount.tally(self.cost, func, args, kwargs, out)
        return out


_POINTWISE: dict = {}


def _pointwise_on_meta(func, args, kwargs):
    """A pointwise op on ``meta`` tensors, made without aten's meta kernel
    (a Python reference for most pointwise ops, ~250 us a call): the
    broadcast shape, the dtype the op gives on one-element CPU tensors of
    the same dtypes and ranks, contiguous.  None where that does not apply
    (other ops, ``out=``, several outputs, other devices)."""
    fast = _POINTWISE.get(func)
    if fast is None:
        fast = _POINTWISE[func] = (torch.Tag.pointwise in func.tags
                                   and len(func._schema.returns) == 1)
    if not fast or "out" in kwargs:
        return None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "meta" for t in tensors):
        return None
    if func._schema.name.endswith("_") or func._schema.returns[0].alias_info is not None:
        return args[0]  # in place: the first argument, its shape and dtype

    key = (func, tuple((a.dtype, a.dim() > 0) if isinstance(a, torch.Tensor) else type(a)
                       for a in args), tuple((k, type(v)) for k, v in kwargs.items()))
    dtype = _DTYPES.get(key)
    if dtype is None:
        def probe(a):
            if isinstance(a, torch.Tensor):
                return torch.zeros((1,) * a.dim(), dtype=a.dtype)
            return a

        with torch.utils._python_dispatch._disable_current_modes():
            dtype = _DTYPES[key] = func(*(probe(a) for a in args), **kwargs).dtype
    return torch.empty(_broadcast(t.shape for t in tensors), dtype=dtype, device="meta")


_DTYPES: dict = {}


def _broadcast(shapes) -> list[int]:
    out: list[int] = []
    for shape in shapes:
        shape = list(shape)
        if len(shape) > len(out):
            out = [1] * (len(shape) - len(out)) + out
        off = len(out) - len(shape)
        for i, n in enumerate(shape):
            m = out[off + i]
            if m == 1:
                out[off + i] = n
            elif n != 1 and n != m:
                raise RuntimeError(f"shapes do not broadcast: {m} against {n}")
    return out


def meta_mesh(shape):
    """A (data, model) mesh of ``shape`` over the ``meta`` device."""
    from repro_torch.core.query import meta_devices
    from repro_torch.launch import mesh as meshlib

    with meta_devices():
        return meshlib.make_mesh(tuple(shape), ("data", "model"),
                                 ["meta"] * int(torch.tensor(shape).prod()))


def program_args(program, mesh) -> tuple:
    """A program's arguments at its ``in_specs`` (``meta`` tensors): an
    engine program's forest sharded over ``mesh``, the others as they are
    (their ``fn`` places them on its mesh)."""
    if program.meta is not None:
        from repro_torch.core import engine as eng

        fspec, *rest = program.in_specs
        return (eng.shard_forest(fspec, mesh), *rest)
    return tuple(program.in_specs)


def measure(fn, args) -> dict:
    """Run ``fn(*args)`` once on ``meta`` tensors under the counters: the
    ``flopcount.Cost``, the collectives' wire bytes by kind (summed over
    positions) and the peak live bytes (the arguments included)."""
    from repro_torch.core.query import meta_devices
    from repro_torch.dist import collectives as col
    from repro_torch.launch import flopcount

    cost = flopcount.Cost()
    live = LiveBytes(cost)
    col.reset_wire()
    with meta_devices(), flopcount.collecting(cost), live:
        live.hold(args)
        out = fn(*args)
    arg = _by_storage(args)
    return dict(cost=cost, wire=col.wire_bytes(), peak=live.peak, arg_bytes=sum(arg.values()),
                out_bytes=sum(nb for cd, nb in _by_storage(out).items() if cd not in arg))


def _by_storage(x) -> dict[int, int]:
    """{storage: bytes} of the tensors in ``x``, each storage once."""
    out = {}
    for t in _storages(x):
        if t.layout == torch.strided:
            s = t.untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def storage_bytes(x) -> int:
    """Bytes of the distinct storages the tensors of ``x`` lie in."""
    return sum(_by_storage(x).values())


def mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


def run_cell(arch_id: str, shape_id: str, mesh_shape, out_dir: str, force: bool = False,
             verbose: bool = True, smoke: bool = False) -> dict:
    from repro_torch.launch import programs, roofline

    name = mesh_name(mesh_shape)
    key = f"{arch_id}__{shape_id}__{name}" + ("__smoke" if smoke else "")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    t0 = time.time()
    rec = {"arch": arch_id, "shape": shape_id, "mesh": name, "smoke": smoke, "ok": False}
    try:
        mesh = meta_mesh(mesh_shape)
        prog = programs.build(arch_id, shape_id, mesh, smoke=smoke)
        t_build = time.time() - t0
        got = measure(prog.fn, program_args(prog, mesh))
        chips = len(mesh.devices)
        r = roofline.analyze(prog.name, name, chips, got["cost"], got["wire"], prog.model_flops,
                             peak_mem_bytes=got["peak"])
        rec.update(r.to_dict())
        rec.update(ok=True, t_build_s=round(t_build, 2), t_run_s=round(time.time() - t0 - t_build, 2),
                   flops=got["cost"].flops, bytes_naive=got["cost"].bytes_naive,
                   flops_bf16=got["cost"].flops_bf16, flops_f32=got["cost"].flops_f32,
                   flops_other=got["cost"].flops_other, wire_bytes=got["wire"],
                   arg_bytes=got["arg_bytes"], out_bytes=got["out_bytes"],
                   temp_bytes=max(got["peak"] - got["arg_bytes"], 0))
        if verbose:
            print(roofline.fmt_row(r), f"[run {rec['t_run_s']:.1f}s]", flush=True)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"FAIL {key}: {rec['error']}", flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def parse_mesh(text: str) -> tuple[int, int]:
    data, model = (int(x) for x in text.lower().split("x"))
    return data, model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", action="append", type=parse_mesh, metavar="DATAxMODEL",
                    help="a (data, model) mesh of meta devices, e.g. 1x1 (one card) or 2x4 "
                         "(one 8-card node); repeatable (default: both)")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    from repro_torch.launch import programs

    meshes = args.mesh or list(DEFAULT_MESHES)
    if args.all:
        cells = list(programs.all_cells())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --all or both --arch and --shape")
    work = [(a, s, m) for a, s in cells for m in meshes]
    t0 = time.time()
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn")) as pool:
            recs = list(pool.map(_run_one, [(*w, args.out, args.force, args.smoke)
                                            for w in work]))
    else:
        recs = [run_cell(a, s, m, args.out, force=args.force, smoke=args.smoke)
                for a, s, m in work]
    n_ok = sum(bool(r.get("ok")) for r in recs)
    n_fail = len(recs) - n_ok
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed in {time.time() - t0:.1f}s")
    return 1 if n_fail else 0


def _run_one(job) -> dict:
    arch_id, shape_id, mesh_shape, out, force, smoke = job
    torch.set_num_threads(1)
    return run_cell(arch_id, shape_id, mesh_shape, out, force=force, smoke=smoke)


if __name__ == "__main__":
    raise SystemExit(main())
