"""Halo exchange for row-sharded separable convolution.

The counterpart of `hybridquantization_tpu/parallel/halo.py`. The vertical
pass of the S-CIELAB filter needs `half` rows of context above and below
each rank's row strip. Interior strip boundaries exchange real neighbour
rows (one batched send and receive per neighbour); the true top and bottom
image edges apply the reference's half-sample reflection
(OptimizedConvolution.cl:21-27). Reflection happens only at true image
edges, never at shard boundaries (SURVEY.md section 7 "hard parts").
"""

from __future__ import annotations

import torch

from ..ops.conv import conv1d_valid
from .mesh import PIXEL_AXIS, Mesh


def exchange_row_halos(x: torch.Tensor, half: int, mesh: Mesh, axis: str = PIXEL_AXIS):
    """(top_halo, bottom_halo) of `half` rows for a (..., C, Hs, W) strip.

    Interior ranks receive their neighbours' rows; the first and last rank
    of the line reflect their own strip (row -m reads row m - 1, row
    Hs - 1 + m reads row Hs - m). Needs Hs >= half.
    """
    n = mesh.size(axis)
    i = mesh.index(axis)
    reflect_top = x[..., :half, :].flip(-2)
    reflect_bottom = x[..., -half:, :].flip(-2)
    if n == 1:
        return reflect_top, reflect_bottom
    # a rank's top rows sit below the previous rank's strip; its bottom
    # rows above the next rank's
    from_above, from_below = mesh.exchange(x[..., :half, :], x[..., -half:, :], axis)
    top = reflect_top if i == 0 else from_above
    bottom = reflect_bottom if i == n - 1 else from_below
    return top, bottom


def conv1d_vertical_sharded(
    x: torch.Tensor, kernels: torch.Tensor, mesh: Mesh, axis: str = PIXEL_AXIS
) -> torch.Tensor:
    """Per-channel vertical 1-D filter of a row-sharded (..., C, Hs, W)
    strip (ops.conv.conv1d_symmetric on the whole image, split by rows).
    Needs Hs >= taps // 2."""
    top, bottom = exchange_row_halos(x, kernels.shape[1] // 2, mesh, axis)
    return conv1d_valid(torch.cat([top, x, bottom], dim=-2), kernels, axis=-2)
