"""Assignment, S-CIELAB filtering and the fitness kernels (B1, B2, B3)."""

from .assign import assign_with_usage, nearest_palette, palette_usage, quantize_image
from .conv import conv1d_symmetric, separable_conv2d_symmetric

__all__ = [
    "nearest_palette",
    "palette_usage",
    "assign_with_usage",
    "quantize_image",
    "conv1d_symmetric",
    "separable_conv2d_symmetric",
]
