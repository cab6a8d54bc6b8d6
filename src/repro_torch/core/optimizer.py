"""BGP query optimizer — a thin façade over the algebra/planner layer.

The conjunctive-query entry points of the JAX package's
``core/optimizer.py``; the machinery lives one layer down:

  * ``core.algebra``   — operator tree + solution-table algebra (and the
    shared anon-variable / projection helpers);
  * ``core.planner``   — cardinality estimation, greedy + DP cost-based
    join ordering, and sideways-information-passing execution of
    conjunctive blocks over the engine's pooled serve step.

:func:`run_bgp` lowers its pattern list to a ``Join``-of-``Scan`` tree and
executes it through :func:`repro_torch.core.planner.execute`; the names
``TriplePattern``, ``estimate_cardinality``, ``plan``,
``_resolve_with_bindings`` and the candidate helpers re-export from their
homes.  Variables are strings starting with ``'?'``; bindings come back as
numpy arrays.  ``Engine.compile(BgpQ(...))`` runs :func:`run_bgp` under the
cap policy of its ``ExecConfig``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import algebra, planner
from repro_torch.core.algebra import TriplePattern  # noqa: F401  (re-export)
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.planner import (  # noqa: F401  (re-exports)
    _candidate_preds,
    _pattern_holds,
    _ragged_candidates,
    _ragged_take,
    _resolve_with_bindings,
    estimate_cardinality,
)


def plan(store: K2TriplesStore, patterns: list[TriplePattern]) -> list[int]:
    """Greedy selectivity-ordered plan (see ``planner.greedy_order``);
    estimate ties break by lowest pattern index, so the order is stable
    across runs.  The cost-based search is ``planner.cost_order``."""
    return planner.greedy_order(store, patterns)


def run_bgp(
    store: K2TriplesStore, patterns: list[TriplePattern], *, cap: int = 2048,
    serve=None,
) -> dict[str, np.ndarray]:
    """Plan + execute; returns columnar variable bindings (deduplicated).

    ``serve`` optionally routes check / bounded-scan steps through the
    engine's pooled serve step (``Engine._lanes_runner``); truncation
    raises :class:`~repro_torch.core.query.CapOverflow` for the plan's
    growth policy to handle.

    At least one pattern must carry a variable — for a fully ground
    (ASK-style) query the columnar return type cannot distinguish "holds"
    from "fails"; use a check-shaped ``TriplePatternQ`` instead.
    """
    if not any(p.variables for p in patterns):
        raise ValueError(
            "a BGP needs at least one pattern with a variable; use "
            "k2forest.check / a check-shaped TriplePatternQ for fully "
            "ground queries"
        )
    table = planner.execute(store, algebra.bgp(patterns), cap=cap, serve=serve)
    return algebra.project_named(table.cols, keep=table.cols)
