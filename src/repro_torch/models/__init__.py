"""Model families: the decoder-only transformer LM (``transformer.py``,
its layers ``layers.py``, on a mesh ``transformer_mesh.py``), the GNN
family (``gnn/``: EGNN, MACE, GraphCast, EquiformerV2) and the recsys
family's xDeepFM (``recsys/xdeepfm.py``, with the MLP helpers of
``gnn/common.py``)."""
