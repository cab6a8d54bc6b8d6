"""The GNN family: EGNN, MACE, GraphCast and EquiformerV2 on the shared
graph plumbing (``common.py``) and the SO(3) substrate (``so3.py``); the
recsys model uses ``common``'s MLP helpers too."""
