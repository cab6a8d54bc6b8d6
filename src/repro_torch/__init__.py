"""k²-triples in PyTorch: the serve path of ``repro`` on an NVIDIA card.

Layout mirrors ``repro``: ``core/`` (store, traversals, engine), ``kernels/``
(hand-written CUDA kernels, their plain torch versions and the wrappers that
pick between them), ``data/`` (synthetic corpora) and ``launch/`` (broker and
serving benchmark).  Entry points default to ``device="cuda"`` and raise when
no card is present; tests pass ``device="cpu"`` explicitly.
"""
