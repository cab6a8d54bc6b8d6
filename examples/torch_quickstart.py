"""Quickstart on the PyTorch port: N3 text -> dictionary -> k²-triples
store -> compiled plans, on an NVIDIA card (``--device cpu`` runs the
kernels' plain versions on the host).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Queries are declarative (``TriplePatternQ`` / ``JoinQ``), execution knobs
live in one frozen ``ExecConfig``, and ``Engine.compile`` returns a cached
``Plan`` — compile once, run many.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import engine, k2triples  # noqa: E402
from repro_torch.core.query import ExecConfig, JoinQ, TriplePatternQ  # noqa: E402
from repro_torch.data import rdf  # noqa: E402

N3 = """
<http://ex/alice>   <http://ex/knows>    <http://ex/bob> .
<http://ex/alice>   <http://ex/knows>    <http://ex/carol> .
<http://ex/bob>     <http://ex/knows>    <http://ex/carol> .
<http://ex/carol>   <http://ex/worksAt>  <http://ex/acme> .
<http://ex/bob>     <http://ex/worksAt>  <http://ex/acme> .
<http://ex/acme>    <http://ex/locatedIn> <http://ex/berlin> .
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    store = k2triples.from_string_triples(rdf.parse_n3(N3), device=args.device)
    d = store.dictionary
    E = engine.Engine(store, device=args.device)
    cfg = ExecConfig(cap=64, device=args.device)
    print(
        f"store: {store.n_triples} triples, {store.n_preds} predicates, "
        f"matrix side {store.meta.side}, structure {store.stats.total_bits} bits "
        f"({store.stats.total_bits / store.n_triples:.1f} bits/triple)"
    )
    out = {}

    alice = d.encode_subject("http://ex/alice")
    knows = d.encode_predicate("http://ex/knows")
    works = d.encode_predicate("http://ex/worksAt")
    acme = d.encode_object("http://ex/acme")

    # (S, P, ?O): who does alice know?
    plan = E.compile(TriplePatternQ(alice, knows, "?who"), cfg)
    out["alice knows"] = [d.decode_object(int(o)) for o in plan()]
    print("alice knows:", out["alice knows"])

    # the same compiled plan serves any (S, P, ?O) query — here as a batch
    bob = d.encode_subject("http://ex/bob")
    out["batched"] = [[d.decode_object(int(o)) for o in objs]
                      for objs in plan({"s": [alice, bob], "p": [knows, works]})]
    for objs in out["batched"]:
        print("  batched lane:", objs)

    # (?S, P, O): who works at acme?
    out["works at acme"] = [d.decode_subject(int(s))
                            for s in E.compile(TriplePatternQ("?s", works, acme), cfg)()]
    print("works at acme:", out["works at acme"])

    # (S, ?P, ?O): everything about alice
    about = E.compile(TriplePatternQ(alice, "?p", "?o"), cfg)()
    out["about alice"] = {d.decode_predicate(p): [d.decode_object(int(o)) for o in objs]
                          for p, objs in about.items()}
    for p, objs in out["about alice"].items():
        print(f"alice --{p}--> ", objs)

    # join A (SO cross-join): ?X such that alice knows ?X and ?X works at acme
    xs = E.compile(
        JoinQ("A", vpos1="o", vpos2="s", p1=knows, c1=alice, p2=works, c2=acme), cfg)()
    out["join A"] = [d.decode_object(int(x)) for x in xs]
    print("alice knows ∩ works-at-acme:", out["join A"])
    return out


if __name__ == "__main__":
    main()
