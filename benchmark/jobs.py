"""The jobs a cell sends, through the program's public entries.

A configuration states the engine (`"engine": "single"` for
`pipeline.HybridQuantizer`, `"batch"` for `parallel.BatchQuantizer` under
`batching.run_bucketed`), its constants and its image set; a traffic mix
states the schedule of a job (K, seeding, iterations, polish, error
image). A job starts from host arrays and ends with what the user
keeps on the host: the palette, the quantized image and the mean Delta-E
(for the batch, the error images as well).

A run imports the program through this module alone.
"""

from __future__ import annotations

import numpy as np
import torch

from hybridquantization_tpu_torch import QuantizationConfig, ScielabConfig, SWASAConfig
from hybridquantization_tpu_torch.batching import bucket_by_resolution, run_bucketed
from hybridquantization_tpu_torch.parallel import BatchQuantizer
from hybridquantization_tpu_torch.pipeline import HybridQuantizer

from .record import Record
from .tracing import Tracer


class Stopped(Exception):
    """The window closed inside a job, at a boundary of its work."""


def quantization_config(config: dict, traffic: dict) -> QuantizationConfig:
    """The engine's configuration: the configuration's constants and the
    traffic mix's schedule (K, seeding, iterations)."""
    eng = dict(config["engine"])
    swasa = {**eng.pop("swasa"), "num_colors": traffic["colors"], "imax": traffic["imax"]}
    scielab = eng.pop("scielab")
    return QuantizationConfig(
        swasa=SWASAConfig(**swasa), scielab=ScielabConfig(**scielab), init=traffic["init"], **eng,
    )


class SingleEngine:
    """One image a job through `HybridQuantizer`."""

    def __init__(self, config: dict, traffic: dict, device, tracer: Tracer):
        self.cfg = quantization_config(config, traffic)
        self.traffic, self.device, self.tracer = traffic, torch.device(device), tracer
        self.engine = HybridQuantizer(self.cfg, self.device)

    def job(self, index: int, image: np.ndarray, seed: int, stop=lambda: False, finish=False):
        """Run one image; returns (Record, None) when it finished, or (None,
        share of its iterations done) when `stop()` ended its anneal after
        a chunk. With `finish`, a stopped anneal's palette goes on through
        the later stages all the same (a warm-up of every stage)."""
        t, tr, sw = self.traffic, self.tracer, self.cfg.swasa
        H, W, _ = image.shape

        def progress(done, imax, _telemetry):
            tr.mark(done=done)
            return not stop()

        with tr.span("upload"):
            img = torch.from_numpy(image).to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with tr.span("find_palette", pixels=H * W, images=1, colors=sw.num_colors,
                     population=sw.population, precision=self.cfg.precision) as span:
            pal, info = self.engine.find_palette(img, generator=gen, progress=progress)
            span["iterations"] = info["iterations"]
        if info["iterations"] < sw.imax and not finish:
            return None, info["iterations"] / sw.imax
        anneal = pal.cpu().numpy()
        if t.get("polish", 0):
            with tr.span("polish"):
                pal = self.engine.polish(img, pal, iters=t["polish"])
        with tr.span("quantize"):
            out = self.engine.quantize(img, pal)
        mean_de = viz = None
        if t.get("error_image"):
            with tr.span("error_image"):
                mean, viz = self.engine.error_image(img, out)
                mean_de, viz = float(mean), viz[..., 0]
        with tr.span("download"):
            rec = Record(index, anneal, info["best_error"], pal.cpu().numpy(), out.cpu().numpy(),
                         mean_de, viz)
        return rec, None


class BatchEngine:
    """The whole image set a job, through the path of `quantize-batch`
    (`cli.py` `_quantize_batch`, without the file I/O): `run_bucketed`
    over `BatchQuantizer.run` and `error_images`, a bucket at a time, each
    handed the bucket's host stack as the CLI hands it (so each stage
    uploads it), and the quantized images, palettes and whole error
    images copied back to the host."""

    def __init__(self, config: dict, traffic: dict, device, tracer: Tracer):
        self.cfg = quantization_config(config, traffic)
        self.traffic, self.device, self.tracer = traffic, torch.device(device), tracer
        self.engine = BatchQuantizer(self.cfg, device=self.device)
        for name in ("find_palettes", "polish", "quantize", "error_images"):
            setattr(self.engine, name, self._spanned(name, getattr(self.engine, name)))

    def _spanned(self, name, fn):
        sw = self.cfg.swasa

        def call(images, *args, **kwargs):
            B, H, W = np.shape(images)[:3]
            with self.tracer.span(name, pixels=H * W, images=B, colors=sw.num_colors,
                                  population=sw.population, precision=self.cfg.precision) as span:
                out = fn(images, *args, **kwargs)
                if name == "find_palettes":
                    span["iterations"] = out[1]["iterations"]
                return out

        return call

    def job(self, images: list[np.ndarray], seeds: list[int], stop=lambda: False, bucket_done=None):
        """Run the set; returns one Record per image. After each bucket
        `bucket_done(pixels, images)` is called, and `stop()` true then
        raises Stopped where buckets remain."""
        t = self.traffic
        order = bucket_by_resolution([im.shape[:2] for im in images])
        buckets = iter(order)
        left = [len(order)]

        def run_batch(stack):
            bucket = next(buckets)
            left[0] -= 1
            if tuple(stack.shape[1:3]) != tuple(bucket.resolution):
                raise RuntimeError("buckets ran out of the order bucket_by_resolution gives")
            out, info = self.engine.run(stack, seeds=[seeds[i] for i in bucket.indices],
                                        polish_iters=t.get("polish", 0))
            res = (out.cpu().numpy(), info["best_errors"], info["palettes"].cpu().numpy(),
                   info["state"].best_colors.cpu().numpy())
            if t.get("error_image"):
                de, viz = self.engine.error_images(stack, out)
                res = (*res, de.cpu().numpy(), viz.cpu().numpy())
            if bucket_done is not None:
                bucket_done(stack.shape[0] * stack.shape[1] * stack.shape[2], stack.shape[0])
            if left[0] and stop():
                raise Stopped
            return res

        slots = run_bucketed(images, run_batch)
        return [
            Record(i, s[3], float(s[1]), s[2], s[0],
                   float(s[4]) if len(s) > 4 else None, s[5] if len(s) > 4 else None)
            for i, s in enumerate(slots)
        ]


def build_seconds() -> float | None:
    """Seconds the program's nvcc build took in this process (None if the
    library was already built in the checkout)."""
    from hybridquantization_tpu_torch.ops import _cuda

    return _cuda.build_info.get("seconds")


def make_engine(config: dict, traffic: dict, device, tracer: Tracer):
    kinds = {"single": SingleEngine, "batch": BatchEngine}
    return kinds[config["engine_kind"]](config, traffic, device, tracer)
