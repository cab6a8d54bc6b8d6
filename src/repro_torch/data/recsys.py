"""Synthetic CTR batches (Criteo-shaped) for xDeepFM: the JAX package's
``repro.data.recsys``, the same numpy arrays for a seed (numpy only)."""

from __future__ import annotations

import numpy as np


def ctr_batch(batch: int, n_fields: int, rows_per_field: int, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    # zipf-ish id popularity like real CTR logs
    ids = (rows_per_field * rng.random((batch, n_fields)) ** 2.5).astype(np.int64)
    ids = np.clip(ids, 0, rows_per_field - 1).astype(np.int32)
    labels = (rng.random(batch) < 0.25).astype(np.int32)
    return {"ids": ids, "labels": labels}


def multi_hot_bags(batch: int, rows: int, max_per_bag: int = 6, *, seed: int = 0):
    """Ragged multi-hot field flattened to (ids, bag_ids) for EmbeddingBag."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_per_bag + 1, batch)
    bag_ids = np.repeat(np.arange(batch), counts).astype(np.int32)
    ids = rng.integers(0, rows, counts.sum()).astype(np.int32)
    return ids, bag_ids, counts
