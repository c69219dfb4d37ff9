"""Batched quantization of many images: on one GPU, and over a rank mesh.

`BatchQuantizer` is the one-device engine: a bucket of B same-resolution
images, each annealed to its own K-colour palette (BASELINE config 4). On
one TPU chip the JAX engine vmaps the fast path's pallas_calls over the
bucket (`parallel/fast.py:349-389`); here the bucket anneals in lockstep
(swasa.loop with a leading image axis), so every iteration launches B1 and
B2 once for the whole bucket, with the image axis in their grids.

`ShardedBatchQuantizer`, the counterpart of JAX's
(`parallel/batch.py:52-411`), runs the same bucket over a mesh of ranks
(parallel.mesh): the images over the data axis, the population over pop,
and each image's columns (parallel.fast) or rows (parallel.sharded) over
pixel (BASELINE configs 4-5).

Image i draws from its own `torch.Generator`, seeded with seeds[i], in the
order its single-image run draws (k-means starts, then the anneal's steps),
so image i of a bucket equals `HybridQuantizer(replace(cfg,
seed=seeds[i])).find_palette(image_i)`: its result depends only on its
image and seed, never on the bucket's composition or order, the property
JAX's per-image keys give (`parallel/batch.py:215-222`). JAX draws its
k-means starts from a second key, seeds + 0x9E3779B9 (`:234-244`); the
port draws both from the one generator (ROADMAP C). The k-means seeding,
the polish and quantize run over the bucket too, as JAX vmaps them
(`parallel/batch.py:28-50`): one B3 launch a Lloyd step (all images x
members) and one for quantize. The error images run once per image.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import colorspace as cs
from ..config import QuantizationConfig
from ..metrics import span
from ..ops import assign as assign_ops
from ..ops.kmeans import kmeans_init_palettes
from ..pipeline import (
    HybridQuantizer,
    ProgressFn,
    _make_batch_context,
    as_image,
    make_population_fitness,
)
from ..scielab.transform import stacked_kernels
from ..swasa import loop as swasa_loop
from . import fast
from .mesh import DATA_AXIS, PIXEL_AXIS, POP_AXIS, Mesh, batch_state_sharding, make_mesh, row_sharding
from .population import rank_sum
from .sharded import build_sharded_fns, pad_rows, row_plan, strip_scielab


STRATEGIES = ("auto", "rows", "columns")


def _seeds(seeds, B: int, cfg: QuantizationConfig) -> list[int]:
    """One seed per image: `seeds`, or arange(B) + config.seed."""
    if seeds is None:
        seeds = np.arange(B) + cfg.seed
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    if len(seeds) != B:
        raise ValueError(f"{len(seeds)} seeds for {B} images")
    return seeds


def _init_colors(generators, images: torch.Tensor, cfg: QuantizationConfig):
    """(B, pop, K, 3) k-means starts (init="kmeans"), or None for the
    reference's random init: one seeding for the bucket (one histogram
    pass, one launch a Lloyd step), each image's starts drawn from its own
    generator."""
    if cfg.init != "kmeans":
        return None
    return kmeans_init_palettes(
        generators, images.reshape(images.shape[0], -1, 3), cfg.swasa.num_colors,
        cfg.swasa.population,
    )


def _anneal(state, fitness, cfg: QuantizationConfig, progress, chunk_size, batch_mean=np.mean, agree=bool):
    """imax iterations in chunks: (state, iterations done, seconds, telemetry
    dict of (iterations, B) arrays). progress is called after each chunk
    with {"best_error_mean", "eta_s"} and stops the search when it returns
    False; batch_mean turns the chunk's last best errors into the mean over
    the batch, agree a stop into the decision every rank takes."""
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
                "best_error_mean": float(batch_mean(telemetry["best_error"][-1])),
                "eta_s": elapsed / done * (imax - done),
            }
            with span("progress"):
                go_on = progress(done, imax, stats)
            if agree(go_on is False):
                break
    telemetry = {k: np.concatenate([t[k] for t in traj]) for k in traj[0]} if traj else {}
    return state, done, time.time() - start, telemetry


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
        with span("batch.find_palettes"):
            cfg = self.config
            images = self._images(images)
            seeds = _seeds(seeds, images.shape[0], cfg)
            generators = tuple(torch.Generator(device=self.device).manual_seed(s) for s in seeds)
            init_colors = _init_colors(generators, images, cfg)
            fitness = make_population_fitness(
                _make_batch_context(images, self.filters, cfg, self.device), cfg
            )
            state = swasa_loop.init_state(generators, fitness, cfg.swasa, init_colors)
            state, done, seconds, telemetry = _anneal(state, fitness, cfg, progress, chunk_size)
            info = {
                "best_errors": state.best_error.cpu().numpy(),
                "iterations": done,
                "seconds": seconds,
                "telemetry": telemetry,
                "state": state,
            }
            return state.best_colors, info

    def quantize(self, images, palettes) -> torch.Tensor:
        """(B, H, W, 3): each image through its own palette, one B3 launch
        for the bucket (HybridQuantizer.quantize without dither)."""
        with span("batch.quantize"):
            images = self._images(images)
            return assign_ops.quantize_in_space(
                images, as_image(palettes, self.device), self.config.assignment_space,
                self.engine._whitepoint,
            )

    def polish(self, images, palettes, iters: int = 10) -> torch.Tensor:
        """Each image's Lloyd refinement (HybridQuantizer.polish), one B3
        launch a step for the bucket."""
        with span("batch.polish"):
            images = self._images(images)
            return assign_ops.polish_palette(
                images.reshape(images.shape[0], -1, 3), as_image(palettes, self.device),
                self.config.assignment_space, self.engine._whitepoint, iters,
            )

    def error_images(self, originals, quantized):
        """((B,) mean S-CIELAB Delta-E, (B, H, W, 3) viz): the reference's
        error-image mode (HybridQuantization.java:139-182) per image."""
        with span("batch.error_images"):
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


class ShardedBatchQuantizer(BatchQuantizer):
    """Quantize a batch of same-resolution images across a rank mesh.

    Usage (every rank of the mesh makes the same calls on the same batch):
        mesh = make_mesh(n_data=2, n_pixel=4)
        q = ShardedBatchQuantizer(QuantizationConfig(...), mesh)
        palettes, info = q.find_palettes(images)     # images: (B, H, W, 3)
        out = q.quantize(images, palettes)

    Data rank d takes images d*B/n_data .. (d+1)*B/n_data - 1. Image i draws
    from its own generator seeded with seeds[i], as in BatchQuantizer (its
    k-means starts, then the anneal's draws); every rank of its pop and
    pixel lines holds the same state and draws the same proposals, and the
    line's collectives give every one of them the same fitness bits. The
    per-image stages that need the whole image (k-means seeding, polish)
    run on every rank of the lines, the same on each; quantize and the
    error images are row-sharded. Results come back to every rank, gathered
    over the data axis (JAX's `_fetch`), as tensors on the rank's device.
    """

    def __init__(self, config: QuantizationConfig | None = None, mesh: Mesh | None = None,
                 strategy: str = "auto"):
        """strategy: "auto" takes the column-sharded kernel fitness
        (parallel.fast) where its column plan is feasible and the
        row-sharded one (parallel.sharded) elsewhere; "rows" and "columns"
        force one ("columns" raises where its plan is infeasible)."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; options: {list(STRATEGIES)}")
        self.mesh = mesh if mesh is not None else make_mesh(1, None)
        super().__init__(config, self.mesh.device)
        self.strategy = strategy
        self._rows = build_sharded_fns(self.mesh, self.config, self.filters)
        self._columns = None
        if strategy != "rows" and fast.supports_fast(self.config):
            self._columns = fast.build_sharded_fast_fns(self.mesh, self.config, self.filters)

    @property
    def n_data(self) -> int:
        return self.mesh.size(DATA_AXIS)

    @property
    def n_pixel(self) -> int:
        return self.mesh.size(PIXEL_AXIS)

    @property
    def n_pop(self) -> int:
        """Population (EP) axis size (parallel.population)."""
        return self.mesh.size(POP_AXIS)

    def _mine(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's images of a (B, ...) stack."""
        return x[batch_state_sharding(self.mesh, x.shape[0])]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(b, ...) per-image results of every data rank -> (B, ...)."""
        return self.mesh.all_gather(x, DATA_AXIS).flatten(0, 1)

    def _use_fast(self, H: int, W: int) -> bool:
        """The column-sharded kernel fitness where the shape allows it."""
        if self._columns is None:
            return False
        half = self.filters.half_width
        ok = fast.plan_fast(H, W, half, self.n_pixel)[1]
        if self.strategy == "columns" and not ok:
            raise ValueError(fast.infeasible(H, W, half, self.n_pixel))
        return ok

    def find_palettes(self, images, seeds=None, progress: ProgressFn | None = None,
                      chunk_size: int | None = None):
        """(B, K, 3) palettes + info, on every rank (BatchQuantizer's
        contract; info["state"] is this rank's, of its data rank's images)."""
        cfg = self.config
        images = self._images(images)
        B, H, W, _ = images.shape
        seeds = _seeds(seeds, B, cfg)
        local = self._mine(images)
        generators = tuple(
            torch.Generator(device=self.device).manual_seed(s)
            for s in seeds[batch_state_sharding(self.mesh, B)]
        )
        init_colors = _init_colors(generators, local, cfg)
        prepare = (self._columns if self._use_fast(H, W) else self._rows)[0]
        fitness = prepare(local)
        state = swasa_loop.init_state(generators, fitness, cfg.swasa, init_colors)

        def batch_mean(last):
            return float(self._gather(torch.as_tensor(last, device=self.device)).mean())

        def agree(stop: bool) -> bool:
            flag = torch.tensor([int(stop)], dtype=torch.int32, device=self.device)
            return bool(self.mesh.all_gather(flag).any())

        state, done, seconds, telemetry = _anneal(
            state, fitness, cfg, progress, chunk_size, batch_mean, agree
        )
        gathered = {}
        for k, v in telemetry.items():
            parts = self.mesh.all_gather(torch.as_tensor(v, device=self.device), DATA_AXIS)
            gathered[k] = parts.permute(1, 0, 2).reshape(v.shape[0], B).cpu().numpy()
        info = {
            "best_errors": self._gather(state.best_error).cpu().numpy(),
            "iterations": done,
            "seconds": seconds,
            "telemetry": gathered,
            "state": state,
        }
        return self._gather(state.best_colors), info

    def quantize(self, images, palettes) -> torch.Tensor:
        """(B, H, W, 3), row-sharded over the pixel axis (B3)."""
        images = self._images(images)
        palettes = as_image(palettes, self.device)
        return self._gather(self._rows[1](self._mine(images), self._mine(palettes)))

    def polish(self, images, palettes, iters: int = 10) -> torch.Tensor:
        """Per-image Lloyd refinement of this data rank's images, gathered."""
        images = self._images(images)
        palettes = as_image(palettes, self.device)
        return self._gather(super().polish(self._mine(images), self._mine(palettes), iters))

    def error_images(self, originals, quantized):
        """((B,) mean S-CIELAB Delta-E, (B, H, W, 3) viz) across the mesh:
        BatchQuantizer.error_images with the S-CIELAB transforms row-sharded
        (halo exchange), rows padded to the shard multiple by mirroring
        (masked out of the mean, cropped from the viz) and the mean's sums
        totalled in rank order."""
        originals, quantized = self._images(originals), self._images(quantized)
        if originals.shape != quantized.shape:
            raise ValueError(f"shape mismatch {tuple(originals.shape)} vs {tuple(quantized.shape)}")
        cfg, mesh = self.config, self.mesh
        _, H, W, _ = originals.shape
        H_pad = row_plan(H, self.n_pixel, self.filters.half_width)
        rows = row_sharding(mesh, H_pad)
        kh = stacked_kernels(self.filters, vertical=False, device=self.device)
        kv = stacked_kernels(self.filters, vertical=True, device=self.device)
        wp = self.engine._whitepoint
        lab_o, lab_q = (
            strip_scielab(pad_rows(self._mine(x), H_pad)[:, rows], kh, kv, wp, mesh)
            for x in (originals, quantized)
        )
        e = cs.DELTA_E_FNS[cfg.deltaE](lab_o, lab_q)  # (b, Hs, W)
        row_ok = torch.arange(rows.start, rows.stop, device=self.device) < H
        local = torch.where(row_ok[:, None], e, 0.0).sum(dim=(-2, -1), dtype=torch.float64).float()
        mean = rank_sum(mesh.all_gather(local, PIXEL_AXIS)) / (H * W)
        # the reference's viz mapping ((255 - e)^2) / 255^2 (ImageManipulation.java:890)
        viz = ((255.0 - e) ** 2) / (255.0**2)
        viz = torch.cat(list(mesh.all_gather(viz, PIXEL_AXIS)), dim=1)[:, :H]
        viz = self._gather(viz)
        return self._gather(mean), viz[..., None].expand(*viz.shape, 3)
