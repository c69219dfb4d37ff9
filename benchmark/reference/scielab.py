"""S-CIELAB of an sRGB image (ImageManipulation.XYZtoScielab,
ImageManipulation.java:285-370), written out plainly.

sRGB -> opponent; each opponent channel c filtered by the sum of its
separable components, horizontal then vertical, each 1-D pass mirrored
at the borders by half-sample reflection (OptimizedConvolution.cl:21-27):

    out_c = sep(opp_c, k1_c, k1_c) + sep(opp_c, k2_c, k2_c)
          + [c == 0] sep(opp_0, k3, |k3|)

then opponent -> XYZ -> CIELAB.
"""

from __future__ import annotations

import torch

from . import color
from .filters import ScielabFilters
from .precision import Precision


def _mirror(n: int, half: int, device) -> torch.Tensor:
    i = torch.arange(-half, n + half, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - i - 1, i)


def conv1d(x: torch.Tensor, taps, axis: int, prec: Precision) -> torch.Tensor:
    """out[j] = sum_t k[t] * x[mirror(j - half + t)] along `axis` of a 2-D x."""
    k = prec.operand(prec.cast(taps).to(x.device))
    half = k.shape[0] // 2
    n = x.shape[axis]
    xp = prec.operand(x).index_select(axis, _mirror(n, half, x.device))
    out = torch.zeros_like(x)
    for t in range(k.shape[0]):
        out += k[t] * xp.narrow(axis, t, n)
    return out


def _separable(x: torch.Tensor, kh, kv, prec: Precision) -> torch.Tensor:
    return conv1d(conv1d(x, kh, 1, prec), kv, 0, prec)


def filter_opp(opp_hwc: torch.Tensor, filters: ScielabFilters, prec: Precision) -> torch.Tensor:
    """(H, W, 3) opponent image -> (H, W, 3) filtered."""
    out = []
    for c in range(3):
        x = opp_hwc[..., c]
        y = _separable(x, filters.k1[:, c], filters.k1[:, c], prec)
        y = y + _separable(x, filters.k2[:, c], filters.k2[:, c], prec)
        if c == 0:
            y = y + _separable(x, filters.k3, filters.k3_abs, prec)
        out.append(y)
    return torch.stack(out, dim=-1)


def srgb_to_scielab(image_hwc, filters: ScielabFilters, whitepoint: str, prec: Precision) -> torch.Tensor:
    """sRGB (H, W, 3) -> S-CIELAB (H, W, 3) in `prec`."""
    opp = color.srgb_to_opp(prec.cast(image_hwc), prec)
    return color.opp_to_lab(filter_opp(opp, filters, prec), whitepoint, prec)
