"""The recsys family: xDeepFM (``xdeepfm.py``)."""
