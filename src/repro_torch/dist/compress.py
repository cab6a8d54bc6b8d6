"""int8 error-feedback gradient mean over a mesh axis (the cross-pod link saver).

The 'pod' mesh axis rides the slow links between pods, so the gradient
mean there is the one collective worth compressing.  Scheme, per position
of the axis:

  1. **error feedback**: x = g + e, where e is the residual carried from the
     previous call: quantisation bias turns into dither instead of drift;
  2. **shared scale**: scale = pmax(|x|) / 127 over the axis, so every
     position quantises against the same grid and the sum of the
     decompressed values is exact up to its own rounding;
  3. q = round(x / scale) in int8 (half to even, clipped to ±127): 4x fewer
     bytes on the wire than f32;
  4. the new residual e' = x - scale·q stays on its position.

With a fixed gradient the time average of the output converges to the
exact mean at O(scale/N): the sum over calls telescopes to N·g + e_0 - e_N.
No caller yet (nor in the JAX package).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.dist import collectives as col

_TINY = torch.finfo(torch.float32).tiny


def quantize(x: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32) of f32 ``x`` against the shared ``amax``."""
    scale = torch.clamp(amax, min=_TINY) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _residual(x: torch.Tensor, qs) -> torch.Tensor:
    """x - scale·q rounded once, as a fused multiply-subtract (XLA contracts
    the reference's ``x - deq`` to one): exact in f64 (q has 8 bits)."""
    q, scale = qs
    return (x.double() - q.double() * scale.double()).float()


def compress_decompress_psum(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor], mesh,
                             axis) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Compressed mean over the positions of ``axis`` (a mesh axis name or
    a tuple of them), with error feedback.

    ``gs``: each position's gradient (any float dtype and shape); ``errs``:
    each position's residual from the previous call (zeros at the first).
    Returns (the mean a position, the new residual a position), both f32;
    the mean is an exact ``psum(g) / n`` up to one int8 step.
    """
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    xs = col.per_position(lambda g, e: g.float() + e.float(), mesh, gs, errs)
    amax = col.pmax(col.per_position(lambda x: x.abs().max(), mesh, xs), mesh, axes)
    qs = col.per_position(quantize, mesh, xs, amax)
    deq = col.per_position(lambda qs_: qs_[0].float() * qs_[1], mesh, qs)
    new_err = col.per_position(_residual, mesh, xs, qs)
    n = float(mesh.size(axes))
    mean = col.per_position(lambda s: s / n, mesh, col.psum(deq, mesh, axes))
    return mean, new_err
