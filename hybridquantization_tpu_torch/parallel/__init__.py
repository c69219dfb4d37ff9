"""Batched quantization on one GPU (the JAX package's `parallel` on a mesh of one).

Only the batch engine is ported; the mesh, halo exchange, sharded fitness and
multi-process runtime need more than one GPU (ROADMAP A13).
"""

from .batch import BatchQuantizer

__all__ = ["BatchQuantizer"]
