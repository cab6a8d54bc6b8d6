"""Shared GNN helpers of the JAX package's ``repro.models.gnn.common``:
so far the MLP (``mlp_specs``, ``mlp_apply``), which xDeepFM's DNN tower
uses.  The graph batch, the segment ops and ``mlp_params`` come with the
GNN family (ROADMAP Queue 1)."""

from __future__ import annotations

import torch


def mlp_specs(dims: list[int]) -> dict:
    """An MLP's weights ``w[i]`` [dims[i], dims[i + 1]] and biases
    ``b[i]``, f32, on the ``meta`` device."""
    return {
        "w": [torch.empty((a, b), dtype=torch.float32, device="meta")
              for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.empty((b,), dtype=torch.float32, device="meta") for b in dims[1:]],
    }


def mlp_apply(p: dict, x: torch.Tensor, act=torch.nn.functional.silu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` a layer (weights cast to ``x``'s dtype), ``act``
    between layers and, with ``final_act``, after the last."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x
