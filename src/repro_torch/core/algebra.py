"""Relational algebra over solution tables — the SPARQL-shaped layer.

The paper stops at conjunctive (BGP) joins; a production endpoint needs the
rest of the SPARQL surface.  This module is the layer between the
declarative ``core.query`` descriptions and the serve IR: a small operator
tree

    ``Scan``      one triple pattern (a BGP leaf)
    ``Join``      natural inner join (conjunction)
    ``LeftJoin``  OPTIONAL — left rows survive unmatched, right-only
                  variables come back :data:`UNBOUND`
    ``Union``     branch union (columns aligned, missing vars UNBOUND)
    ``Filter``    3-valued-logic expression filter (SPARQL errors drop rows)
    ``Project``   keep named columns (+ dedup)
    ``Slice``     ORDER BY + LIMIT/OFFSET over a deterministic total order

evaluated over **solution tables** — columnar ``{var: int64[n]}`` maps in
which ``UNBOUND == 0`` marks an OPTIONAL-introduced hole (dictionary ids
are 1-based, so 0 is free).  ``core.planner`` walks the tree: conjunctive
regions (``Join``-of-``Scan``) are flattened back into BGPs, cost-ordered,
and executed through the pooled serve-IR programs with sideways
information passing; everything here is the host-side table algebra those
blocks compose under.

Results are **set semantics** (DISTINCT implied, like the BGP layer);
``Slice`` makes LIMIT deterministic by sorting over the ORDER BY keys
*followed by every remaining column in sorted-name order* — a total order,
so a truncated result is reproducible and differential-testable.

This module is dependency-light on purpose (numpy + dataclasses only).
It keeps the JAX package's ``core/algebra.py`` semantics exactly — row
order and dtypes included, since the planner dedups with ``np.unique``
— and ``tests/test_torch_select.py`` holds the two against each other.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

Term = Any  # int (bound 1-based id) | str '?var'

UNBOUND = np.int64(0)  # ids are 1-based; 0 marks an OPTIONAL-unbound slot
ANON = "?__anon"  # internal prefix for anonymous (None) positions
INTERNAL = "?__"  # every internal helper column lives under this prefix
_ROWID = "?__ljrow"  # LeftJoin's transient left-row tag


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    """One BGP triple pattern: ints bind, ``"?name"`` strings are variables."""

    s: Term
    p: Term
    o: Term

    @property
    def variables(self) -> set[str]:
        return {t for t in (self.s, self.p, self.o) if isinstance(t, str)}


def is_var(t: Term) -> bool:
    return isinstance(t, str)


# ---------------------------------------------------------------------------
# filter expressions (SPARQL-style 3-valued logic)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cmp:
    """``lhs <op> rhs`` over dictionary ids; an UNBOUND operand is a SPARQL
    type error (the row is dropped unless a surrounding Or/Not saves it)."""

    op: str  # one of == != < <= > >=
    lhs: Term
    rhs: Term

    def __post_init__(self):
        if self.op not in _CMP_FNS:
            raise ValueError(f"unknown comparison {self.op!r}")


@dataclasses.dataclass(frozen=True)
class Bound:
    """SPARQL ``BOUND(?var)`` — true iff the column holds a real id."""

    var: str


@dataclasses.dataclass(frozen=True)
class And:
    a: Any
    b: Any


@dataclasses.dataclass(frozen=True)
class Or:
    a: Any
    b: Any


@dataclasses.dataclass(frozen=True)
class Not:
    e: Any


_CMP_FNS = {
    "==": np.equal, "!=": np.not_equal,
    "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}


def expr_vars(expr) -> set[str]:
    if isinstance(expr, Cmp):
        return {t for t in (expr.lhs, expr.rhs) if isinstance(t, str)}
    if isinstance(expr, Bound):
        return {expr.var}
    if isinstance(expr, (And, Or)):
        return expr_vars(expr.a) | expr_vars(expr.b)
    if isinstance(expr, Not):
        return expr_vars(expr.e)
    raise TypeError(f"not a filter expression: {expr!r}")


def eval_expr(expr, t: "Table", scope: set[str]):
    """Evaluate to SPARQL 3-valued logic: ``(value, error)`` bool arrays.

    ``scope`` is the set of variables the expression may see (the
    *syntactic* variables of the filtered subtree) — a variable outside it
    is unbound regardless of what columns ride along in ``t``, so results
    never depend on whether a sideways-information-passing seed happened
    to add extra columns.  Error propagation follows SPARQL:
    ``false && error = false``, ``true || error = true``, errors filter.
    """
    n = t.n

    def operand(x):
        if isinstance(x, str):
            if x in scope and x in t.cols:
                c = t.cols[x]
                return c, c == UNBOUND
            return np.zeros(n, np.int64), np.ones(n, np.bool_)
        return np.full(n, int(x), np.int64), np.zeros(n, np.bool_)

    if isinstance(expr, Cmp):
        lv, lu = operand(expr.lhs)
        rv, ru = operand(expr.rhs)
        err = lu | ru
        return _CMP_FNS[expr.op](lv, rv) & ~err, err
    if isinstance(expr, Bound):
        if expr.var in scope and expr.var in t.cols:
            return t.cols[expr.var] != UNBOUND, np.zeros(n, np.bool_)
        return np.zeros(n, np.bool_), np.zeros(n, np.bool_)
    if isinstance(expr, And):
        av, ae = eval_expr(expr.a, t, scope)
        bv, be = eval_expr(expr.b, t, scope)
        a_false = ~av & ~ae
        b_false = ~bv & ~be
        err = (ae | be) & ~a_false & ~b_false
        return av & bv, err
    if isinstance(expr, Or):
        av, ae = eval_expr(expr.a, t, scope)
        bv, be = eval_expr(expr.b, t, scope)
        err = (ae | be) & ~av & ~bv
        return (av | bv) & ~err, err
    if isinstance(expr, Not):
        v, e = eval_expr(expr.e, t, scope)
        return ~v & ~e, e
    raise TypeError(f"not a filter expression: {expr!r}")


# ---------------------------------------------------------------------------
# operator tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scan:
    pattern: TriplePattern


@dataclasses.dataclass(frozen=True)
class Join:
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class LeftJoin:
    """OPTIONAL: every left row survives; unmatched rows carry UNBOUND in
    the right side's own variables."""

    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class Union:
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class Filter:
    expr: Any
    child: Any


@dataclasses.dataclass(frozen=True)
class Project:
    child: Any
    vars: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Slice:
    """ORDER BY + LIMIT/OFFSET.  ``order_by`` entries are ``"?v"``
    (ascending) or ``"-?v"`` (descending); remaining columns in
    sorted-name order break ties, so the cut is deterministic."""

    child: Any
    order_by: tuple[str, ...] = ()
    limit: int | None = None
    offset: int = 0


Node = Any  # Scan | Join | LeftJoin | Union | Filter | Project | Slice


def bgp(patterns) -> Node:
    """A conjunction as a left-deep ``Join`` tree of ``Scan`` leaves."""
    pats = [
        p if isinstance(p, TriplePattern) else TriplePattern(p.s, p.p, p.o)
        for p in patterns
    ]
    if not pats:
        raise ValueError("a BGP needs at least one pattern")
    node: Node = Scan(pats[0])
    for p in pats[1:]:
        node = Join(node, Scan(p))
    return node


def flatten_bgp(node) -> list[TriplePattern] | None:
    """The conjunctive region under ``node`` as a pattern list, or ``None``
    when the subtree contains non-conjunctive operators.  This is what the
    planner cost-orders as ONE BGP block."""
    if isinstance(node, Scan):
        return [node.pattern]
    if isinstance(node, Join):
        left = flatten_bgp(node.left)
        right = flatten_bgp(node.right)
        if left is not None and right is not None:
            return left + right
    return None


def node_vars(node) -> set[str]:
    """The syntactic variables a subtree can bind (its visible columns)."""
    if isinstance(node, Scan):
        return set(node.pattern.variables)
    if isinstance(node, (Join, LeftJoin, Union)):
        return node_vars(node.left) | node_vars(node.right)
    if isinstance(node, Filter):
        return node_vars(node.child)  # a filter binds nothing
    if isinstance(node, Project):
        return set(node.vars)
    if isinstance(node, Slice):
        return node_vars(node.child)
    raise TypeError(f"not an algebra node: {node!r}")


# ---------------------------------------------------------------------------
# solution tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Table:
    """Columnar solution multiset: ``cols[var]`` is ``int64[n]``; the row
    count is explicit so zero-column tables (pure existence results) can
    still distinguish one row from none."""

    cols: dict[str, np.ndarray]
    n: int

    def __post_init__(self):
        self.cols = {
            k: np.asarray(v, np.int64).reshape(-1) for k, v in self.cols.items()
        }
        for k, v in self.cols.items():
            if v.shape[0] != self.n:
                raise ValueError(f"column {k} has {v.shape[0]} rows, not {self.n}")

    @classmethod
    def unit(cls) -> "Table":
        """The join identity: one row, no columns."""
        return cls({}, 1)

    @classmethod
    def empty(cls, vars=()) -> "Table":
        return cls({v: np.zeros(0, np.int64) for v in vars}, 0)

    @classmethod
    def from_bindings(cls, bindings: dict[str, np.ndarray]) -> "Table":
        n = len(next(iter(bindings.values()))) if bindings else 0
        return cls(dict(bindings), n)

    def take(self, idx) -> "Table":
        idx = np.asarray(idx)
        return Table({v: c[idx] for v, c in self.cols.items()}, int(idx.shape[0]))


# pairwise-match block size: caps the boolean compatibility matrix a
# generic (non-SIP) join materializes at any one time
_JOIN_BLOCK = 1 << 22


def join_tables(a: Table, b: Table) -> Table:
    """SPARQL-compatible natural join: two rows merge when every shared
    variable agrees *or is UNBOUND on either side* (the merged value is the
    bound one).  O(n·m) pair test, blocked to bound memory — the generic
    fallback; conjunctive regions never come here (the planner feeds them
    through the serve IR with sideways information passing instead)."""
    shared = [v for v in a.cols if v in b.cols]
    out_vars = list(a.cols) + [v for v in b.cols if v not in a.cols]
    if a.n == 0 or b.n == 0:
        return Table.empty(out_vars)
    ai_parts, bi_parts = [], []
    step = max(1, _JOIN_BLOCK // max(b.n, 1))
    for lo in range(0, a.n, step):
        hi = min(lo + step, a.n)
        ok = np.ones((hi - lo, b.n), np.bool_)
        for v in shared:
            av = a.cols[v][lo:hi, None]
            bv = b.cols[v][None, :]
            ok &= (av == bv) | (av == UNBOUND) | (bv == UNBOUND)
        ia, ib = np.nonzero(ok)
        ai_parts.append(ia + lo)
        bi_parts.append(ib)
    ai = np.concatenate(ai_parts)
    bi = np.concatenate(bi_parts)
    cols = {}
    for v in a.cols:
        av = a.cols[v][ai]
        if v in b.cols:
            cols[v] = np.where(av != UNBOUND, av, b.cols[v][bi])
        else:
            cols[v] = av
    for v in b.cols:
        if v not in a.cols:
            cols[v] = b.cols[v][bi]
    return Table(cols, int(ai.shape[0]))


def left_join_tables(a: Table, b: Table) -> Table:
    """OPTIONAL: inner-join rows plus every unmatched left row padded with
    UNBOUND in the right-only variables."""
    aa = Table({**a.cols, _ROWID: np.arange(a.n, dtype=np.int64)}, a.n)
    j = join_tables(aa, b)
    matched = np.zeros(a.n, np.bool_)
    if j.n:
        matched[j.cols[_ROWID]] = True
    miss = np.nonzero(~matched)[0]
    cols = {}
    for v in j.cols:
        if v == _ROWID:
            continue
        pad = (
            a.cols[v][miss]
            if v in a.cols
            else np.full(miss.shape[0], UNBOUND, np.int64)
        )
        cols[v] = np.concatenate([j.cols[v], pad])
    return Table(cols, j.n + int(miss.shape[0]))


def union_tables(a: Table, b: Table) -> Table:
    """Branch union: columns aligned over the union of variables, a branch
    missing a variable contributes UNBOUND there."""
    out_vars = list(a.cols) + [v for v in b.cols if v not in a.cols]

    def col(t, v):
        return t.cols.get(v, np.full(t.n, UNBOUND, np.int64))

    return Table(
        {v: np.concatenate([col(a, v), col(b, v)]) for v in out_vars},
        a.n + b.n,
    )


def distinct(t: Table) -> Table:
    """Set semantics: unique rows (column order normalized by name)."""
    if not t.cols:
        return Table({}, min(t.n, 1))
    keys = sorted(t.cols)
    stacked = np.stack([t.cols[k] for k in keys], axis=1)
    uniq = np.unique(stacked, axis=0)
    return Table({k: uniq[:, i] for i, k in enumerate(keys)}, uniq.shape[0])


def sort_slice(
    t: Table, order_by: tuple[str, ...], limit: int | None, offset: int = 0
) -> Table:
    """Deduplicate, totally order, and cut.

    Sort keys are the ORDER BY entries (``"-?v"`` descends) followed by
    every remaining column in sorted-name order — a total order over
    distinct rows, so LIMIT is deterministic (differential-testable).
    UNBOUND (0) sorts before every real id, matching SPARQL's
    unbound-first convention.
    """
    t = distinct(t)
    keys = []
    named = set()
    for spec in order_by:
        desc = spec.startswith("-")
        v = spec[1:] if desc else spec
        named.add(v)
        c = t.cols.get(v, np.full(t.n, UNBOUND, np.int64))
        keys.append(-c if desc else c)
    for v in sorted(t.cols):
        if v not in named:
            keys.append(t.cols[v])
    if keys:
        idx = np.lexsort(tuple(reversed(keys)))
    else:
        idx = np.arange(t.n)
    stop = t.n if limit is None else min(t.n, offset + limit)
    return t.take(idx[offset:stop])


# ---------------------------------------------------------------------------
# shared variable-binding helpers (the one home for anon/projection logic)
# ---------------------------------------------------------------------------


def name_anon(patterns, start: int = 0) -> list[TriplePattern]:
    """Materialize anonymous (``None``) positions as reserved internal
    variables so the planner can join through them; ``project_named``
    drops them again.  ``start`` offsets the numbering so several blocks
    of one query never collide on an anon name.  The ONE implementation —
    the BgpQ and SelectQ lowerings and the optimizer shims all route
    here."""
    return [
        TriplePattern(
            *(
                f"{ANON}{start + i}{k}" if t is None else t
                for k, t in zip("spo", (tp.s, tp.p, tp.o))
            )
        )
        for i, tp in enumerate(patterns)
    ]


def from_select(q) -> Node:
    """Lower a ``SelectQ``-shaped query description to an algebra tree.

    ``q`` is duck-typed (``where``/``union``/``optional``/``filter``/
    ``select``/``order_by``/``limit``/``offset``) so this module stays
    import-free of :mod:`repro_torch.core.query`.  Composition follows the
    SPARQL group-graph-pattern order: WHERE joined with the UNION group,
    then each OPTIONAL block left-joined, then FILTERs, then projection
    and the ORDER/LIMIT slice.
    """
    idx = 0

    def named(block):
        nonlocal idx
        out = name_anon(block, start=idx)
        idx += len(block)
        return out

    node: Node | None = None
    if q.where:
        node = bgp(named(q.where))
    if q.union:
        ub: Node | None = None
        for branch in q.union:
            bn = bgp(named(branch))
            ub = bn if ub is None else Union(ub, bn)
        node = ub if node is None else Join(node, ub)
    if node is None:
        raise ValueError("SelectQ needs a WHERE or UNION block")
    for opt in q.optional:
        node = LeftJoin(node, bgp(named(opt)))
    for ex in q.filter:
        node = Filter(ex, node)
    # always project: SELECT * means "every NAMED variable" — anonymous
    # (?__anon) join columns must never leak, and projecting BEFORE the
    # Slice keeps the ORDER BY total order over visible columns only
    sel = (
        tuple(q.select)
        if q.select is not None
        else tuple(
            sorted(v for v in node_vars(node) if not v.startswith(INTERNAL))
        )
    )
    node = Project(node, sel)
    if q.order_by or q.limit is not None or q.offset:
        node = Slice(node, tuple(q.order_by), q.limit, q.offset)
    return node


def project_named(
    bindings: dict[str, np.ndarray], keep=None
) -> dict[str, np.ndarray]:
    """Project a columnar binding dict to ``keep`` (default: every
    non-internal column) and deduplicate the surviving rows — the shared
    tail of BGP/Select execution, previously duplicated between the
    optimizer and the BgpQ lowering."""
    if keep is None:
        keep = sorted(k for k in bindings if not k.startswith(INTERNAL))
    else:
        keep = sorted(keep)
    if not keep:
        return {}
    stacked = np.stack(
        [np.asarray(bindings[k], np.int64) for k in keep], axis=1
    )
    uniq = np.unique(stacked, axis=0)
    return {k: uniq[:, i] for i, k in enumerate(keep)}
