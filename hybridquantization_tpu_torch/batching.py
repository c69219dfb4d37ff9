"""Mixed-resolution batch orchestration (NumPy copy).

A verbatim copy of `hybridquantization_tpu/batching.py` below this
paragraph: importing anything from the JAX package imports jax, which this
package never does. `tests/test_torch_batch.py` pins the copy equal to the
original. In this package a bucket is one batched anneal on one GPU
(parallel.batch.BatchQuantizer), and n_data stays 1.

BASELINE config 4 is "a batch of 64 mixed-resolution images": XLA needs
static shapes, so images are grouped into same-resolution buckets and each
bucket runs as one sharded batch (one compile per distinct resolution).
Buckets are padded up to the data-axis size with repeats so the mesh stays
fully utilized; repeated results are dropped.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np


@dataclass
class Bucket:
    resolution: tuple[int, int]      # (H, W)
    indices: list[int]               # positions in the original request


def bucket_by_resolution(sizes: list[tuple[int, int]]) -> list[Bucket]:
    """Group image indices by exact (H, W)."""
    groups: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    for i, hw in enumerate(sizes):
        groups[tuple(hw)].append(i)
    return [Bucket(res, idx) for res, idx in sorted(groups.items())]


def pad_indices(indices: list[int], multiple: int) -> tuple[list[int], int]:
    """Repeat trailing indices so len % multiple == 0; returns (padded, real)."""
    real = len(indices)
    if multiple <= 1 or real % multiple == 0:
        return list(indices), real
    pad = multiple - real % multiple
    return list(indices) + [indices[-1]] * pad, real


def run_bucketed(images: list[np.ndarray], run_batch, n_data: int = 1):
    """Apply `run_batch(stacked_images) -> (outputs, errors)` per bucket.

    images: list of (H_i, W_i, 3) float arrays (mixed resolutions).
    run_batch: callable on a (B, H, W, 3) stack returning per-image results
      as a tuple of arrays with leading dim B.
    Returns results re-ordered to match the input list.
    """
    sizes = [im.shape[:2] for im in images]
    buckets = bucket_by_resolution(sizes)
    slots: list = [None] * len(images)
    for b in buckets:
        padded, real = pad_indices(b.indices, n_data)
        stack = np.stack([images[i] for i in padded])
        outs = run_batch(stack)
        for pos, orig_idx in enumerate(b.indices[:real]):
            slots[orig_idx] = tuple(np.asarray(o[pos]) for o in outs)
    return slots
