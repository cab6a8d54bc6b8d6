"""The GNN family's shared helpers; only the MLP helpers are ported so
far (``common.py``), which the recsys model uses."""
