"""Serve SPARQL triple patterns from a compressed in-memory store on the
PyTorch port (``repro_torch.launch.serve``), on an NVIDIA card by default.

    PYTHONPATH=src python examples/torch_serve_sparql.py --triples 100000
    PYTHONPATH=src python examples/torch_serve_sparql.py --fast --device cpu

Builds a synthetic store (paper Table 1 ratios), compiles one batched
serve plan, then replays a skewed multi-tenant query trace through the
streaming broker (``repro_torch.launch.broker``): the paper's
"full-in-memory RDF engine" as a serving loop.  Every flag is
``repro_torch.launch.serve``'s.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> None:
    from repro_torch.launch import serve

    serve.main(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
