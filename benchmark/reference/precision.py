"""The two arithmetics the reference runs in.

`F64` is the reference itself: every value in float64. `TF32` is its
control, the nearest precision below the configuration's fp32 with TF32
off: float32 values whose operands of every product (the colour
matrices, the S-CIELAB filter taps and samples, the palette scores) are
first rounded to TF32's 10 mantissa bits, as a tensor core does when a
matmul or convolution runs in TF32. The control has to come out as not
correct.
"""

from __future__ import annotations

import dataclasses

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest even at 10 mantissa bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype

    def cast(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """x as an operand of a product."""
        return tf32_round(x) if self.name == "tf32" else x


F64 = Precision("f64", torch.float64)
TF32 = Precision("tf32", torch.float32)
PRECISIONS = {p.name: p for p in (F64, TF32)}
