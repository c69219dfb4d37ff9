"""Colour conversions and Delta-E, written out from the plugin's constants.

sRGB gamma (OptimizedConvolution.cl:85-87), the 3x3 matrices of
ScielabProcessor.java:24-43, CIELAB (ScielabProcessor.java:333-343,
OptimizedConvolution.cl:137) and CIE76 (OptimizedConvolution.cl:209), in
the arithmetic of a `Precision`. Images are (..., 3) tensors.
"""

from __future__ import annotations

import torch

from .precision import Precision

M_SRGB2XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
M_XYZ2OPP = (
    (0.2787336, 0.7218031, -0.1065520),
    (-0.4487736, 0.2898056, -0.0771569),
    (0.0859513, -0.5899859, 0.5011089),
)
M_OPP2XYZ = (
    (0.624045, -1.87044, -0.155304),
    (1.36606, 0.931563, 0.433903),
    (1.5013, 1.41761, 2.53307),
)
WHITEPOINTS = {"D65": (0.95047, 1.0, 1.0883), "D50": (0.966797, 1.0, 0.825188)}
LAB_DELTA3 = (6.0 / 29.0) ** 3
LAB_KAPPA = 24389.0 / 27.0


def _f32(v: float) -> float:
    """A constant as the plugin stores it, a float32."""
    return float(torch.tensor(v, dtype=torch.float32))


def _matrix(rows, prec: Precision) -> torch.Tensor:
    return prec.operand(torch.tensor([[_f32(v) for v in r] for r in rows], dtype=prec.dtype))


def apply(rows, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """x @ M.T over the trailing axis."""
    m = _matrix(rows, prec).to(x.device)
    x = prec.operand(x)
    return torch.stack([x[..., 0] * m[i, 0] + x[..., 1] * m[i, 1] + x[..., 2] * m[i, 2]
                        for i in range(3)], dim=-1)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c.clamp_min(0.0) + 0.055) / 1.055) ** 2.4)


def srgb_to_opp(srgb: torch.Tensor, prec: Precision) -> torch.Tensor:
    srgb = prec.cast(srgb)
    return apply(M_XYZ2OPP, apply(M_SRGB2XYZ, srgb_to_linear(srgb), prec), prec)


def opp_to_lab(opp: torch.Tensor, whitepoint: str, prec: Precision) -> torch.Tensor:
    xyz = apply(M_OPP2XYZ, prec.cast(opp), prec)
    wp = torch.tensor([_f32(v) for v in WHITEPOINTS[whitepoint]], dtype=prec.dtype, device=xyz.device)
    t = xyz / wp
    f = torch.where(t > LAB_DELTA3, t.clamp_min(LAB_DELTA3) ** (1.0 / 3.0), (LAB_KAPPA * t + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def delta_e(lab1: torch.Tensor, lab2: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-pixel Delta-E; the benchmark's configurations state CIE76."""
    if kind != "CIE76":
        raise ValueError(f"the reference implements CIE76 only, not {kind!r}")
    d = lab1 - lab2
    return torch.sqrt(torch.sum(d * d, dim=-1))
