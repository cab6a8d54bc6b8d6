"""Dry run: build every (arch x shape x mesh) cell and run it once on the
``meta`` device, with no card and no memory.

For each cell this shows, without hardware:
  * the program builds and runs on the mesh (every layout and collective
    is exercised on tensors that hold shapes only),
  * how many flops and bytes it does (``flopcount``), what its
    collectives move (``dist.collectives.WIRE``) and the three roofline
    terms of an H100 SXM (``roofline``),
  * and its peak memory: the most bytes that live ``meta`` tensors held
    at once during the run, the arguments included, for each mesh
    position as a card of its own would hold them.  ``peak_mem_bytes``,
    ``arg_bytes``, ``temp_bytes`` and ``out_bytes`` are the position with
    the largest peak's (one device's, as the JAX record's memory analysis
    of the SPMD program is); ``mesh_peak_mem_bytes`` is the whole mesh's,
    the positions sharing the one ``meta`` device and a replicated value
    held once (what a mesh of one card holds).  On (1, 1) the two agree.

A storage counts for the positions that hold it: an argument for those
holding its ``Sharded`` part (the dry run gives each distinct part a
storage of its own), a storage made while a ``collectives.per_position``
call or a collective's combine runs for the positions it serves
(``collectives.served``); one made outside both (the controlling code, an
autograd backward, an optimizer update) for the positions that every
input storage it reads counts for (inputs of no common position: the
positions of any), an ``add`` (autograd summing a gradient's terms) for
the positions of all its inputs, and for the lead, position 0, where no
input is a position's.

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh 1x1 --mesh 2x4]
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch --jobs 6
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k \
        --mesh 2x4 --rule seq_sp=none     # the residual stream whole (no seq_sp)

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

from repro_torch.dist import collectives as col, sharding as shd

DEFAULT_MESHES = ((1, 1), (2, 4))


def _flat_tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _flat_tensors(a)


def _placed_tensors(x, n: int):
    """(tensor, position or None) of every tensor in a program's arguments
    ``x``: a ``Sharded`` value's parts at their positions, a tuple of ``n``
    dataclasses (an engine's forest shards, one a position) likewise."""
    if isinstance(x, (list, tuple)) and n > 1 and len(x) == n and all(
            dataclasses.is_dataclass(v) and not isinstance(v, type) for v in x):
        for p, v in enumerate(x):
            yield from ((t, p) for t in _storages(v))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _placed_tensors(v, n)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _placed_tensors(v, n)
    elif hasattr(x, "parts"):  # a Sharded value
        for p, t in enumerate(x.parts):
            yield t, (p if n > 1 else None)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _placed_tensors(getattr(x, f.name), n)
    else:
        yield from ((t, None) for t in _storages(x))


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
    """The peak of the bytes live storages hold while it is on, in all
    (``peak``) and for each of ``n_positions`` mesh positions
    (``peak_at``): every storage an op makes (and every one passed to
    :meth:`hold`) counts from then until only this mode still refers to
    it, for the positions of the module docstring's rule.  The exact live
    totals are taken only when a new storage could raise a peak.  With a
    ``cost`` it also counts each op (``flopcount.tally``; one mode, not
    two)."""

    def __init__(self, cost=None, n_positions: int = 1):
        super().__init__()
        self.cost = cost
        self.n = n_positions
        # cdata -> [storage, nbytes, positions bitmask]; the bit n_positions marks a storage
        # of no position's (counted for position 0, the lead), which a flow ignores
        self.held: dict[int, list] = {}
        self.upper = 0  # >= the live bytes (frees found at the next sweep)
        self.peak = 0
        self.upper_at = [0] * n_positions
        self.peak_at = [0] * n_positions
        self._unplaced = 1 << n_positions
        self._positions: dict[int, tuple] = {}  # bitmask -> the positions it counts for
        self._masks: dict[tuple, int] = {}  # served positions -> bitmask

    def positions(self, mask: int) -> tuple:
        ps = self._positions.get(mask)
        if ps is None:
            ps = tuple(p for p in range(self.n) if mask >> p & 1)
            if mask & self._unplaced and 0 not in ps:
                ps = (0, *ps)
            self._positions[mask] = ps
        return ps

    def _sweep(self) -> None:
        use = torch._C._storage_Use_Count
        for cd in [cd for cd in self.held if use(cd) <= 1]:
            _, nb, mask = self.held.pop(cd)
            self.upper -= nb
            for p in self.positions(mask):
                self.upper_at[p] -= nb

    def _add(self, cd: int, s, nb: int, mask: int) -> None:
        ps = self.positions(mask)
        if self.upper + nb > self.peak or any(self.upper_at[p] + nb > self.peak_at[p]
                                              for p in ps):
            self._sweep()
        self.held[cd] = [s, nb, mask]
        self.upper += nb
        self.peak = max(self.peak, self.upper)
        for p in ps:
            self.upper_at[p] += nb
            self.peak_at[p] = max(self.peak_at[p], self.upper_at[p])

    def _widen(self, entry: list, mask: int) -> None:
        """An argument's storage held by more positions: count it for them."""
        new = set(self.positions(mask)) - set(self.positions(entry[2]))
        entry[2] |= mask
        for p in sorted(new):
            self.upper_at[p] += entry[1]
            self.peak_at[p] = max(self.peak_at[p], self.upper_at[p])

    def _mask(self, args, func=None) -> int:
        """The positions a storage an op ``func`` makes now counts for."""
        if self.n == 1:
            return 1
        at = col.served()
        if at is not None:
            mask = self._masks.get(at)
            if mask is None:
                mask = self._masks[at] = sum(1 << p for p in at)
            return mask
        inter, union = (1 << self.n) - 1, 0
        for t in _flat_tensors(args):
            e = self.held.get(t.untyped_storage()._cdata) if t.layout == torch.strided else None
            if e is None or e[2] == self._unplaced:
                continue
            inter &= e[2]
            union |= e[2]
        if not union:  # no input of a position's: the lead's
            return self._unplaced
        if func in _SUMS:  # a sum of positions' terms (autograd adding a gradient's): all of them
            return union
        return inter or union

    def hold(self, x, mask: int | None = None) -> None:
        """Count the storages of ``x`` from now, for the positions of
        ``mask`` (default: those of an op's output made now)."""
        for t in _storages(x):
            if t.layout != torch.strided:
                continue
            s = t.untyped_storage()
            cd = s._cdata
            if cd in self.held:
                if mask is not None and mask & ~self.held[cd][2]:
                    self._widen(self.held[cd], mask)
                continue
            self._add(cd, s, s.nbytes(), self._mask(()) if mask is None else mask)

    def hold_args(self, args) -> None:
        """Count a program's arguments: a ``Sharded`` part (or an engine's
        per-position forest shard) for the positions that hold it, anything
        else for the lead."""
        for t, p in _placed_tensors(args, self.n):
            self.hold(t, self._unplaced if p is None else 1 << p)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_on_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        mask = None
        for t in _storages(out):
            if t.layout != torch.strided:
                continue
            s = t.untyped_storage()
            cd = s._cdata
            if cd not in self.held:
                if mask is None:
                    mask = self._mask(args, func)
                self._add(cd, s, s.nbytes(), mask)
            elif func in _SUMS and self.n > 1 and col.served() is None:
                # summed in place outside a position (autograd adding a gradient's terms in its
                # first term's buffer): it now holds every term's positions
                mask = self._mask(args, func)
                if mask & ~self.held[cd][2] and mask != self._unplaced:
                    self._widen(self.held[cd], mask)
        if self.cost is not None:
            from repro_torch.launch import flopcount

            flopcount.tally(self.cost, func, args, kwargs, out)
        return out


_POINTWISE: dict = {}
_SUMS = (torch.ops.aten.add.Tensor, torch.ops.aten.add_.Tensor)


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
    """A program's arguments at its ``in_specs`` (``meta`` tensors): on a
    mesh of several positions laid out as the program lays them out, each
    distinct ``Sharded`` part (an engine's forest shard) a storage of its
    own, as on distinct cards; on one position as they are."""
    from repro_torch.launch import programs

    if program.meta is not None:
        from repro_torch.core import engine as eng

        fspec, *rest = program.in_specs
        shards = eng.shard_forest(fspec, mesh)
        if len(mesh.devices) > 1:
            own = {id(f): dataclasses.replace(f, **{k.name: getattr(f, k.name).clone()
                                                    for k in dataclasses.fields(f) if k.init})
                   for f in shards}
            shards = tuple(own[id(f)] for f in shards)
        return (shards, *rest)
    args = tuple(program.in_specs)
    if program.mesh is None or len(program.mesh.devices) == 1:
        return args
    return _own_parts(programs.place(program, args))


def _own_parts(x):
    """``x`` with each distinct part of every ``Sharded`` value cloned."""
    if isinstance(x, shd.Sharded):
        return shd.map_distinct(torch.clone, x)
    if isinstance(x, dict):
        return {k: _own_parts(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_own_parts(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_own_parts(v) for v in x)
    return x


def measure(fn, args, mesh=None) -> dict:
    """Run ``fn(*args)`` once on ``meta`` tensors under the counters: the
    ``flopcount.Cost``, the collectives' wire bytes by kind (summed over
    positions) and the live bytes, the arguments included: ``mesh_peak``
    the whole run's (every storage once), and with ``mesh`` (its positions
    counted apart) ``peak_at`` / ``arg_at`` / ``out_at`` each position's
    peak, argument and output bytes, ``peak`` / ``arg_bytes`` /
    ``out_bytes`` those of the position with the largest peak (the first
    such).  Without ``mesh`` every storage counts for one position."""
    from repro_torch.core.query import meta_devices
    from repro_torch.launch import flopcount

    cost = flopcount.Cost()
    live = LiveBytes(cost, len(mesh.devices) if mesh is not None else 1)
    col.reset_wire()
    with meta_devices(), flopcount.collecting(cost), live:
        live.hold_args(args)
        out = fn(*args)
        arg = {cd: live.held[cd][2] for cd in _by_storage(args) if cd in live.held}
        outs = {cd: live.held[cd][2] for cd in _by_storage(out)
                if cd in live.held and cd not in arg}
    n = live.n

    def at(masks: dict) -> list[int]:
        tot = [0] * n
        for cd, mask in masks.items():
            for p in live.positions(mask):
                tot[p] += live.held[cd][1]
        return tot

    arg_at, out_at = at(arg), at(outs)
    top = max(range(n), key=lambda p: (live.peak_at[p], -p))
    return dict(cost=cost, wire=col.wire_bytes(), mesh_peak=live.peak, peak_at=live.peak_at,
                arg_at=arg_at, out_at=out_at, peak=live.peak_at[top], arg_bytes=arg_at[top],
                out_bytes=out_at[top])


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


def rules_name(rules: dict | None) -> str:
    """``rules`` as a file-name part: ``seq_sp-none`` for {"seq_sp": None}."""
    return "__".join(f"{k}-{'-'.join(v) if isinstance(v, (list, tuple)) else str(v).lower()}"
                     for k, v in sorted((rules or {}).items()))


def run_cell(arch_id: str, shape_id: str, mesh_shape, out_dir: str, force: bool = False,
             verbose: bool = True, smoke: bool = False, rules: dict | None = None) -> dict:
    """Dry-run one cell (``rules`` amend an LM program's sharding rules)
    and write its record to ``out_dir``; a record already there is read
    back unless ``force``."""
    from repro_torch.launch import programs, roofline

    name = mesh_name(mesh_shape)
    key = (f"{arch_id}__{shape_id}__{name}" + ("__smoke" if smoke else "")
           + (f"__{rules_name(rules)}" if rules else ""))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    t0 = time.time()
    rec = {"arch": arch_id, "shape": shape_id, "mesh": name, "smoke": smoke, "ok": False}
    if rules:
        rec["rules"] = rules
    try:
        mesh = meta_mesh(mesh_shape)
        prog = programs.build(arch_id, shape_id, mesh, smoke=smoke, rules=rules)
        t_build = time.time() - t0
        got = measure(prog.fn, program_args(prog, mesh), mesh)
        chips = len(mesh.devices)
        r = roofline.analyze(prog.name, name, chips, got["cost"], got["wire"], prog.model_flops,
                             peak_mem_bytes=got["peak"])
        rec.update(r.to_dict())
        rec.update(ok=True, t_build_s=round(t_build, 2), t_run_s=round(time.time() - t0 - t_build, 2),
                   flops=got["cost"].flops, bytes_naive=got["cost"].bytes_naive,
                   flops_bf16=got["cost"].flops_bf16, flops_f32=got["cost"].flops_f32,
                   flops_other=got["cost"].flops_other, wire_bytes=got["wire"],
                   arg_bytes=got["arg_bytes"], out_bytes=got["out_bytes"],
                   temp_bytes=max(got["peak"] - got["arg_bytes"], 0),
                   mesh_peak_mem_bytes=got["mesh_peak"])
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


def parse_rule(text: str) -> tuple[str, object]:
    """``NAME=AXIS[,AXIS...]`` or ``NAME=none`` -> (name, rule value)."""
    name, _, value = text.partition("=")
    axes = tuple(a for a in value.split(",") if a)
    if not name or not axes:
        raise ValueError(f"a rule is NAME=AXIS[,AXIS...] or NAME=none, not {text!r}")
    rule = None if axes == ("none",) else axes[0] if len(axes) == 1 else axes
    return name, rule


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
    ap.add_argument("--rule", action="append", type=parse_rule, default=[],
                    metavar="NAME=AXES", help="amend the LM programs' sharding rules, e.g. "
                    "seq_sp=none (the residual stream whole); repeatable")
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
    rules = dict(args.rule) or None
    if rules:
        cells = [(a, s) for a, s in cells if programs.cb.get(a).family == "lm"]
    work = [(a, s, m) for a, s in cells for m in meshes]
    t0 = time.time()
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn")) as pool:
            recs = list(pool.map(_run_one, [(*w, args.out, args.force, args.smoke, rules)
                                            for w in work]))
    else:
        recs = [run_cell(a, s, m, args.out, force=args.force, smoke=args.smoke, rules=rules)
                for a, s, m in work]
    n_ok = sum(bool(r.get("ok")) for r in recs)
    n_fail = len(recs) - n_ok
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed in {time.time() - t0:.1f}s")
    return 1 if n_fail else 0


def _run_one(job) -> dict:
    arch_id, shape_id, mesh_shape, out, force, smoke, rules = job
    torch.set_num_threads(1)
    return run_cell(arch_id, shape_id, mesh_shape, out, force=force, smoke=smoke, rules=rules)


if __name__ == "__main__":
    raise SystemExit(main())
