"""End-to-end quantization engine.

The counterpart of `hybridquantization_tpu/pipeline.py`
(HybridQuantization.quantization, HybridQuantization.java:93-137):

  1. build the S-CIELAB filter bank (host, init-time)
  2. S-CIELAB transform of the original image (device, once)
  3. SWASA search for the best palette (device, in chunks), from random or
     k-means palettes (ops.kmeans), with optional checkpoints
  4. optional Lloyd polish of the palette (ops.assign.polish_palette)
  5. final nearest-palette quantize pass, optionally dithered
  6. optional Delta-E error image (HybridQuantization.java:139-182)

Each fitness evaluation of the search runs the population through the
assignment kernel (ops.assign_kernel, B1) and the fused S-CIELAB Delta-E
kernel (ops.fused_fitness, B2) on a CUDA device; every one-palette lookup
(the k-means and Lloyd steps, quantize) runs the index kernel (B3). On the
CPU the same wrappers run their plain versions. The host sees scalar telemetry between chunks and can stop the
search through the progress callback (the reference's stopFlag,
HybridQuantization.java:312-318).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from . import colorspace as cs
from .checkpoint import save_state
from .config import QuantizationConfig
from .ops import assign as assign_ops
from .ops.assign_kernel import assign_opp_usage_pop
from .ops.fused_fitness import fused_scielab_err_sums, kernel_taps
from .ops.kmeans import kmeans_init_palettes
from .scielab import transform as sct
from .scielab.filters import ScielabFilters, build_filters
from .swasa import loop as swasa_loop
from .swasa import schedule
from .swasa.state import SWASAState

# ProgressFn(iteration, imax, telemetry) -> bool: return False to stop early.
ProgressFn = Callable[[int, int, dict], bool]


def setup_device(device) -> torch.device:
    """Resolve `device` and pin fp32 on it.

    TF32 would round matmul and cuDNN convolution operands to 10 mantissa
    bits, the GPU's counterpart of the TPU's bf16 default that flipped 0.7%
    of assignments; both switches are turned off.
    """
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def as_image(image_hwc, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on `device`."""
    if isinstance(image_hwc, torch.Tensor):
        return image_hwc.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(image_hwc, np.float32), device=device)


def _features(pixels: torch.Tensor, cfg: QuantizationConfig, wp) -> torch.Tensor:
    return cs.srgb_to_lab(pixels, wp) if cfg.assignment_space == "lab" else pixels


def _make_context(
    image_hwc, filters: ScielabFilters, cfg: QuantizationConfig, device="cpu"
) -> dict:
    """Device-resident per-image constants for the fitness function."""
    device = torch.device(device)
    wp = cs.WHITEPOINTS[cfg.scielab.whitepoint]
    image = as_image(image_hwc, device)
    kh = sct.stacked_kernels(filters, vertical=False, device=device)
    kv = sct.stacked_kernels(filters, vertical=True, device=device)
    opp = cs.xyz_to_opp(cs.srgb_to_xyz(image))
    filtered = sct.scielab_filter_stacked(torch.movedim(opp, -1, 0), kh, kv)
    target_lab = cs.opp_to_lab(torch.movedim(filtered, 0, -1), wp)
    return {
        "assign_pixels": _features(image.reshape(-1, 3), cfg, wp).contiguous(),
        "target_lab": target_lab,                                    # (H, W, 3)
        "target_planar": torch.movedim(target_lab, -1, 0).contiguous(),  # (3, H, W)
        "kh": kh,
        "kv": kv,
        "taps_on_host": kernel_taps(kh, kv),  # B2's coefficient parameter
        "whitepoint": tuple(float(v) for v in wp),
    }


def _make_batch_context(
    images_bhwc, filters: ScielabFilters, cfg: QuantizationConfig, device="cpu"
) -> dict:
    """The per-image contexts of a bucket of same-size images, stacked on a
    leading image axis (each image's built on its own, so it is the one its
    single-image run would use)."""
    ctxs = [_make_context(im, filters, cfg, device) for im in images_bhwc]
    stacked = ("assign_pixels", "target_lab", "target_planar")
    ctx = {k: torch.stack([c[k] for c in ctxs]) for k in stacked}
    ctx.update({k: ctxs[0][k] for k in ("kh", "kv", "taps_on_host", "whitepoint")})
    return ctx


def make_fitness(ctx: dict, cfg: QuantizationConfig):
    """Palette (K, 3) -> (scalar fitness, (K,) bool usage), plain torch.

    The reference's per-evaluation pipeline (quantizeAndConvertToOpp ->
    S-CIELAB filter -> Opp2LAB -> Delta-E -> mean + penalty;
    ImageManipulation.java:620-727) for one palette, first-index ties,
    scores at `cfg.precision` and an fp32 filter, as JAX's make_fitness.
    """
    H, W, _ = ctx["target_lab"].shape
    wp = ctx["whitepoint"]
    de_fn = cs.DELTA_E_FNS[cfg.deltaE]

    def fitness(palette: torch.Tensor):
        idx = assign_ops.nearest_palette(
            ctx["assign_pixels"], _features(palette, cfg, wp), cfg.precision
        )
        usage = assign_ops.palette_usage(idx, palette.shape[0])
        q_opp = cs.srgb_to_opp(palette)[idx].T.reshape(3, H, W)
        filtered = sct.scielab_filter_stacked(q_opp, ctx["kh"], ctx["kv"])
        q_lab = cs.opp_to_lab(torch.movedim(filtered, 0, -1), wp)
        err = torch.mean(de_fn(ctx["target_lab"], q_lab))
        return err + schedule.unused_penalty(usage, cfg.swasa.delta), usage

    return fitness


def make_population_fitness(ctx: dict, cfg: QuantizationConfig):
    """(pop, K, 3) palettes -> ((pop,) errors, (pop, K) bool usage); with a
    batch context (`_make_batch_context`), (B, pop, K, 3) -> ((B, pop),
    (B, pop, K)) in one launch of each kernel.

    B1 (assignment at `cfg.precision` and `cfg.tie_mode`, winner opponent
    colour, counts) then B2 (S-CIELAB Delta-E sums at `cfg.conv_precision`
    or else `cfg.precision`), then sums / (H*W) + delta * #unused, as JAX's
    Pallas branch (`hybridquantization_tpu/pipeline.py:209-256`). On a CUDA
    context both are the hand-written kernels; on a CPU context their plain
    versions.
    """
    H, W = ctx["target_lab"].shape[-3:-1]
    wp = ctx["whitepoint"]
    conv_precision = cfg.conv_precision or cfg.precision

    def pop_fitness(palettes: torch.Tensor):
        opp, counts = assign_opp_usage_pop(
            ctx["assign_pixels"],
            assign_ops.per_image(lambda p: _features(p, cfg, wp), palettes, palettes.dim() == 4),
            assign_ops.per_image(cs.srgb_to_opp, palettes, palettes.dim() == 4),
            precision=cfg.precision,
            tie_mode=cfg.tie_mode,
        )
        sums = fused_scielab_err_sums(
            opp.reshape(*palettes.shape[:-2], 3, H, W), ctx["target_planar"], ctx["kh"],
            ctx["kv"], wp, cfg.deltaE, precision=conv_precision, taps_on_host=ctx["taps_on_host"],
        )
        usage = counts > 0
        return sums / (H * W) + schedule.unused_penalty(usage, cfg.swasa.delta), usage

    return pop_fitness


class HybridQuantizer:
    """The single-image engine.

    Usage:
        q = HybridQuantizer(QuantizationConfig(...), device="cuda")
        palette, info = q.find_palette(image)          # (H, W, 3) sRGB float
        palette = q.polish(image, palette)             # optional
        out = q.quantize(image, palette)
        mean_de, err_viz = q.error_image(image, out)

    Tensors it returns lie on `device`; images may be numpy arrays or tensors.
    """

    def __init__(self, config: QuantizationConfig | None = None, device="cuda"):
        self.config = config or QuantizationConfig()
        self.device = setup_device(device)
        self.filters = build_filters(
            self.config.scielab.dpi, self.config.scielab.viewing_distance_cm
        )
        self._whitepoint = cs.WHITEPOINTS[self.config.scielab.whitepoint]

    def _as_image(self, image_hwc) -> torch.Tensor:
        return as_image(image_hwc, self.device)

    # -- S-CIELAB -----------------------------------------------------------

    def scielab(self, image_hwc) -> torch.Tensor:
        """sRGB (H, W, 3) -> S-CIELAB (H, W, 3)."""
        return sct.srgb_to_scielab(self._as_image(image_hwc), self.filters, self._whitepoint)

    # -- Optimization -------------------------------------------------------

    def find_palette(
        self,
        image_hwc,
        generator: torch.Generator | None = None,
        progress: Optional[ProgressFn] = None,
        chunk_size: int | None = None,
        initial_state: SWASAState | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 500,
    ):
        """SWASA search for the best K-color palette.

        Returns (palette (K, 3) float32 sRGB tensor, info dict with the
        fitness trajectory and the final state). `generator` (on the
        quantizer's device) makes every draw; by default one seeded with
        config.seed. With init="kmeans" it first draws the k-means starts
        on the full image, then the initial fitness runs on those palettes
        (the JAX engine's order: its key is split first and the k-means
        starts use the sub-key). `initial_state` (e.g. from
        checkpoint.load_state) resumes a run; `checkpoint_path` writes the
        state atomically every `checkpoint_every` iterations.
        """
        cfg = self.config
        chunk = chunk_size or cfg.progress_every
        image = self._as_image(image_hwc)
        ctx = _make_context(image, self.filters, cfg, self.device)
        fitness = make_population_fitness(ctx, cfg)
        if initial_state is not None:
            state = initial_state
        else:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(cfg.seed)
            init_colors = None
            if cfg.init == "kmeans":
                init_colors = kmeans_init_palettes(
                    generator, image.reshape(-1, 3), cfg.swasa.num_colors, cfg.swasa.population
                )
            state = swasa_loop.init_state(generator, fitness, cfg.swasa, init_colors)

        imax = cfg.swasa.imax
        traj = []
        start = time.time()
        done = int(state.iteration)
        resumed_at = done
        last_ckpt = done
        while done < imax:
            n = min(chunk, imax - done)
            state, telemetry = swasa_loop.run_chunk(state, fitness, cfg.swasa, n)
            done += n
            if checkpoint_path and done - last_ckpt >= checkpoint_every:
                save_state(checkpoint_path, state)
                last_ckpt = done
            traj.append(telemetry)
            if cfg.verbose:
                # population stats parity (ImageManipulation.java:552-565)
                print(
                    f"iter {done}/{imax}  best {telemetry['best_error'][-1]:.5f}"
                    f"  Population:  Mean : {telemetry['mean_error'][-1]:.4f}"
                    f"  Best : {telemetry['min_error'][-1]:.4f}"
                    f"  Std. Dev. : {telemetry['std_error'][-1]:.4f}"
                )
            if progress is not None:
                elapsed = time.time() - start
                last = {k: float(v[-1]) for k, v in telemetry.items()}
                last["eta_s"] = elapsed / max(done - resumed_at, 1) * (imax - done)
                if progress(done, imax, last) is False:
                    break  # cooperative stop (reference stopFlag semantics)

        info = {
            "best_error": float(state.best_error),
            "iterations": done,
            "telemetry": {k: np.concatenate([t[k] for t in traj]) for k in traj[0]}
            if traj
            else {},
            "state": state,
            "seconds": time.time() - start,
        }
        if cfg.verbose:
            print(f"Final error : {info['best_error']:.5f}")
        return state.best_colors, info

    # -- Palette refinement ---------------------------------------------------

    def polish(self, image_hwc, palette, iters: int = 10) -> torch.Tensor:
        """Lloyd (k-means) refinement of a palette in the assignment space.

        Beyond-reference (the reference's anneal is its only optimizer):
        each step moves every entry to the centroid of its assigned pixels,
        monotone in assignment-space MSE; "lab" mode polishes in CIELAB and
        maps back to sRGB with gamut clamping. Below 2^20 pixels the steps
        run per pixel through the B3 kernel on the card, from there on a
        weighted color histogram (ops.assign.polish_palette). The SWASA
        fitness is the spatial S-CIELAB Delta-E, a different objective:
        compare with error_image when it matters.
        """
        return assign_ops.polish_palette(
            self._as_image(image_hwc).reshape(-1, 3),
            self._as_image(palette),
            self.config.assignment_space,
            self._whitepoint,
            iters,
        )

    # -- Quantize / error image --------------------------------------------

    def quantize(self, image_hwc, palette, dither: float = 0.0) -> torch.Tensor:
        """Apply a palette (nearest in the configured assignment space).

        dither > 0 perturbs the pixels with a tiled mean-zero Bayer matrix
        scaled by the sRGB palette spacing before the nearest lookup
        (beyond-reference; less banding in smooth gradients at small K).
        The perturbation is in sRGB; the assignment still uses the
        configured space.
        """
        image = self._as_image(image_hwc)
        pal = self._as_image(palette)
        if dither > 0.0:
            image = assign_ops.dither_perturbation(image, pal, dither)
        return assign_ops.quantize_in_space(
            image, pal, self.config.assignment_space, self._whitepoint
        )

    def error_image(self, original_hwc, quantized_hwc):
        """(mean S-CIELAB Delta-E, (H, W, 3) visualization).

        HybridQuantization.errorImage (HybridQuantization.java:139-182) and
        ImageManipulation.computeError (:858-894), including the
        ((255 - e)^2) / 255^2 visualization mapping (:890).
        """
        e = cs.DELTA_E_FNS[self.config.deltaE](
            self.scielab(original_hwc), self.scielab(quantized_hwc)
        )
        viz = ((255.0 - e) ** 2) / (255.0**2)
        return torch.mean(e), viz[..., None].expand(*viz.shape, 3)

    # -- Full flow ----------------------------------------------------------

    def run(self, image_hwc, generator=None, progress: Optional[ProgressFn] = None):
        """Full reference flow: palette search + quantize (+ metadata)."""
        palette, info = self.find_palette(image_hwc, generator, progress)
        out = self.quantize(image_hwc, palette)
        info["palette"] = palette
        return out, info
