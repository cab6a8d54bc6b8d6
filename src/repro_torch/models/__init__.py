"""Model families: the decoder-only transformer LM (``transformer.py``)
and its layers (``layers.py``)."""
