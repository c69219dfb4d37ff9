"""hybridquantization_tpu_torch — the PyTorch/CUDA port of hybridquantization_tpu.

Perceptual color quantization (SWASA annealing over candidate palettes,
scored by S-CIELAB Delta-E, with optional k-means seeding, Lloyd polish and
ordered dithering) on an NVIDIA GPU, with hand-written Hopper kernels for
the population assignment, the fused S-CIELAB Delta-E fitness and the
polish's nearest-index assignment (`csrc/`), and plain torch everywhere
else. `python -m hybridquantization_tpu_torch.cli` is its command line.
The JAX package `hybridquantization_tpu` is the reference it is tested
against; this package never imports jax.
"""

from . import cpu_math  # first: its import warms torch's CPU sqrt/log up (cpu_math doc)
from . import colorspace
from .config import QuantizationConfig, ScielabConfig, SWASAConfig
from .pipeline import HybridQuantizer

__all__ = [
    "HybridQuantizer",
    "QuantizationConfig",
    "SWASAConfig",
    "ScielabConfig",
    "colorspace",
]
