"""Batched quantization of many images on one GPU.

The one-device counterpart of `hybridquantization_tpu/parallel/batch.py`
(`ShardedBatchQuantizer`): a bucket of B same-resolution images, each
annealed to its own K-colour palette (BASELINE config 4). On one TPU chip
the JAX engine vmaps the fast path's pallas_calls over the bucket
(`parallel/fast.py:349-389`); here the bucket anneals in lockstep
(swasa.loop with a leading image axis), so every iteration launches B1 and
B2 once for the whole bucket, with the image axis in their grids. There is
no mesh: data and pixel sharding wait for more than one GPU (ROADMAP A13).

Image i draws from its own `torch.Generator`, seeded with seeds[i], in the
order its single-image run draws (k-means starts, then the anneal's steps),
so image i of a bucket equals `HybridQuantizer(replace(cfg,
seed=seeds[i])).find_palette(image_i)`: its result depends only on its
image and seed, never on the bucket's composition or order, the property
JAX's per-image keys give (`parallel/batch.py:215-222`). JAX draws its
k-means starts from a second key, seeds + 0x9E3779B9 (`:234-244`); the
port draws both from the one generator (ROADMAP C). The k-means seeding,
the polish, quantize and the error images run once per image.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import QuantizationConfig
from ..ops.kmeans import kmeans_init_palettes
from ..pipeline import (
    HybridQuantizer,
    ProgressFn,
    _make_batch_context,
    as_image,
    make_population_fitness,
)
from ..swasa import loop as swasa_loop


class BatchQuantizer:
    """Quantize a batch of same-resolution images on one GPU.

    Usage:
        q = BatchQuantizer(QuantizationConfig(...), device="cuda")
        palettes, info = q.find_palettes(images)     # images: (B, H, W, 3)
        out = q.quantize(images, palettes)
        mean_de, viz = q.error_images(images, out)

    Tensors it returns lie on `device`; images may be numpy arrays or tensors.
    """

    def __init__(self, config: QuantizationConfig | None = None, device="cuda"):
        self.config = config or QuantizationConfig()
        # the single-image engine serves the per-image stages
        self.engine = HybridQuantizer(self.config, device)
        self.device = self.engine.device
        self.filters = self.engine.filters

    def _images(self, images) -> torch.Tensor:
        images = as_image(images, self.device)
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
        return images

    def find_palettes(
        self,
        images,
        seeds=None,
        progress: ProgressFn | None = None,
        chunk_size: int | None = None,
    ):
        """(B, K, 3) palettes + info. images: (B, H, W, 3) float sRGB.

        seeds: one per image (default arange(B) + config.seed). progress is
        called after each chunk with {"best_error_mean", "eta_s"} and stops
        the search when it returns False. info: "best_errors" (B,) numpy,
        "iterations", "seconds", "telemetry" ((iterations, B) arrays),
        "state".
        """
        cfg = self.config
        images = self._images(images)
        B = images.shape[0]
        if seeds is None:
            seeds = np.arange(B) + cfg.seed
        seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        if len(seeds) != B:
            raise ValueError(f"{len(seeds)} seeds for {B} images")
        generators = tuple(torch.Generator(device=self.device).manual_seed(s) for s in seeds)
        init_colors = None
        if cfg.init == "kmeans":
            init_colors = torch.stack([
                kmeans_init_palettes(g, im.reshape(-1, 3), cfg.swasa.num_colors, cfg.swasa.population)
                for g, im in zip(generators, images)
            ])
        fitness = make_population_fitness(
            _make_batch_context(images, self.filters, cfg, self.device), cfg
        )
        state = swasa_loop.init_state(generators, fitness, cfg.swasa, init_colors)

        imax = cfg.swasa.imax
        chunk = chunk_size or max(cfg.progress_every, 1)
        done = 0
        start = time.time()
        traj = []
        while done < imax:
            n = min(chunk, imax - done)
            state, telemetry = swasa_loop.run_chunk(state, fitness, cfg.swasa, n)
            done += n
            traj.append(telemetry)
            if progress is not None:
                elapsed = time.time() - start
                stats = {
                    "best_error_mean": float(np.mean(telemetry["best_error"][-1])),
                    "eta_s": elapsed / done * (imax - done),
                }
                if progress(done, imax, stats) is False:
                    break
        info = {
            "best_errors": state.best_error.cpu().numpy(),
            "iterations": done,
            "seconds": time.time() - start,
            "telemetry": {k: np.concatenate([t[k] for t in traj]) for k in traj[0]}
            if traj
            else {},
            "state": state,
        }
        return state.best_colors, info

    def quantize(self, images, palettes) -> torch.Tensor:
        """(B, H, W, 3): each image through its own palette (B3)."""
        images = self._images(images)
        return torch.stack([self.engine.quantize(im, p) for im, p in zip(images, palettes)])

    def polish(self, images, palettes, iters: int = 10) -> torch.Tensor:
        """Per-image Lloyd refinement (HybridQuantizer.polish)."""
        images = self._images(images)
        return torch.stack([self.engine.polish(im, p, iters) for im, p in zip(images, palettes)])

    def error_images(self, originals, quantized):
        """((B,) mean S-CIELAB Delta-E, (B, H, W, 3) viz): the reference's
        error-image mode (HybridQuantization.java:139-182) per image."""
        originals, quantized = self._images(originals), self._images(quantized)
        if originals.shape != quantized.shape:
            raise ValueError(f"shape mismatch {tuple(originals.shape)} vs {tuple(quantized.shape)}")
        means, vizs = zip(*(self.engine.error_image(o, q) for o, q in zip(originals, quantized)))
        return torch.stack(means), torch.stack(vizs)

    def run(self, images, seeds=None, progress: ProgressFn | None = None, polish_iters: int = 0):
        """find_palettes + optional Lloyd polish + quantize.

        info["best_errors"] are the anneal's final fitness values; with
        polish_iters > 0 the returned palettes and images are post-polish
        (info["palettes_polished"]), so use error_images() for their
        S-CIELAB Delta-E.
        """
        palettes, info = self.find_palettes(images, seeds, progress)
        info["palettes_polished"] = bool(polish_iters)
        if polish_iters:
            palettes = self.polish(images, palettes, polish_iters)
        out = self.quantize(images, palettes)
        info["palettes"] = palettes
        return out, info
