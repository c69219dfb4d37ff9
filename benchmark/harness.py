"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result.

Set-up makes the cell's image set on the device from the seed, builds the
engine once, as a service holds it, and runs one job of every shape the
cell uses (the first run in a checkout builds the program's kernels
then). The window sends jobs back to back through the engine, one client
in a closed loop. Once it has closed, the peak device memory is read, the
program's state is freed, and the reference judges the sampled answers.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from . import cells, checks, images
from .record import Record
from .tracing import Tracer, breakdown, profiled, union_seconds
from .window import Window, percentile

ORDER = 3  # the derived-seed stream of the job order
FORBIDDEN = ("jax", "jaxlib", "flax", "hybridquantization_tpu")


def image_sizes(config: dict) -> list[tuple[int, int]]:
    return [(g["height"], g["width"]) for g in config["images"] for _ in range(g["count"])]


class Run:
    """A cell's engine, image set and per-image anneal seeds for one run seed."""

    def __init__(self, cell: cells.Cell, seed: int, device, tracer: Tracer):
        from .jobs import make_engine  # the program is imported here, at set-up

        self.cell, self.seed, self.device, self.tracer = cell, seed, torch.device(device), tracer
        # the image set is the configuration's corpus (or its first `frames`),
        # the same in every run; the run seed draws the anneals and the order
        # the jobs take the images in
        sizes = image_sizes(cell.config)[: cell.traffic.get("frames")]
        self.images = images.make_set(sizes, cell.config["corpus_seed"], self.device)
        self.seeds = [images.derived_seed(seed, i, images.ANNEAL) for i in range(len(self.images))]
        self.order = list(range(len(self.images)))
        random.Random(images.derived_seed(seed, 0, ORDER)).shuffle(self.order)
        self.engine = make_engine(cell.config, cell.traffic, self.device, tracer)
        self.batch = cell.config["engine_kind"] == "batch"

    def warm_up(self) -> None:
        """One job of every shape the cell uses; a long anneal only for
        `warmup_chunks` chunks."""
        if self.batch:
            self.engine.job(self.images, self.seeds)
        else:
            chunks = self.cell.traffic.get("warmup_chunks")
            done = [0]

            def stop():
                done[0] += 1
                return chunks is not None and done[0] >= chunks

            i = self.order[0]
            self.engine.job(i, self.images[i], self.seeds[i], stop, finish=True)
        sync(self.device)

    def job(self, n: int, stop=lambda: False, bucket_done=None):
        """Job n of the closed loop: (records or None, in-flight share or None)."""
        if self.batch:
            return self.engine.job(self.images, self.seeds, stop, bucket_done), None
        i = self.order[n % len(self.images)]
        rec, share = self.engine.job(i, self.images[i], self.seeds[i], stop)
        return (None if rec is None else [rec]), share


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(run: Run, seconds: float):
    """The closed loop for `seconds`: (Window, the records of the first
    finished job of each image, attempted). A repeat of an image repeats
    its anneal, so its first job stands for all."""
    from .jobs import Stopped

    traffic = run.cell.traffic
    w = Window(seconds)
    stop = w.due if traffic.get("close_at", "job") != "job" else (lambda: False)
    first: dict[int, list[Record]] = {}
    n = attempted = 0
    while True:
        attempted += 1
        t0 = time.perf_counter()
        try:
            recs, share = run.job(n, stop, lambda px, b: w.finished(None, px, b))
        except Stopped:
            break
        w.job_seconds.append(time.perf_counter() - t0)
        if recs is None:
            w.partial(share)
            break
        if not run.batch:
            w.finished(time.perf_counter() - t0, recs[0].quantized.shape[0] * recs[0].quantized.shape[1])
        first.setdefault(0 if run.batch else recs[0].index, recs)
        n += 1
        if w.due():
            break
    w.close()
    return w, [r for recs in first.values() for r in recs], attempted


def traced(run: Run, jobs: int):
    """`jobs` whole jobs under the profiler: (TraceData, records of the last
    job of each image)."""
    out: dict = {}
    last: dict[int, Record] = {}
    with profiled(run.tracer, out):
        for n in range(jobs):
            with run.tracer.span("job"):
                recs, _ = run.job(n)
            last.update({r.index: r for r in recs})
    return out["trace"], list(last.values())


def judge(run: Run, records: list[Record], control: bool = False):
    """(numbers, reference mean Delta-E by image index) of the records; with
    `control`, of the TF32 control put in the program's place."""
    judge_ = checks.Judge(run.cell.config, run.cell.traffic, run.device)
    per, ref_de = [], {}
    for rec in sorted(records, key=lambda r: r.index):
        image = run.images[rec.index]
        if control:
            rec = judge_.control_record(image, rec)
        numbers, ref_de[rec.index] = judge_.numbers(image, rec)
        per.append(numbers)
    return checks.worst(per), ref_de


def device_info(device) -> dict:
    import subprocess

    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={torch.device(device).index or 0}"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit_w": limit}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            log=sys.stderr) -> dict:
    """One run; returns the result object (without the check of loaded
    modules, which the caller makes last)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    tracer = Tracer(trace)
    run = Run(cell, seed, device, tracer)
    run.warm_up()
    setup_s = time.perf_counter() - t_start
    from .jobs import build_seconds

    print(f"set-up {setup_s:.3f} s (nvcc build in it: {build_seconds()} s)", file=log)

    metrics: dict = {}
    info = device_info(device) if on_card else {"platform": device.type, "kind": "cpu", "count": 1}
    print(f"device {info['kind']}, power limit {info.get('power_limit_w')} W", file=log)
    result: dict = {}
    if trace:
        attempted = int(cell.traffic.get("trace_jobs", 1))
        data, records = traced(run, attempted)
        data.cell, data.taps = cell, checks.Judge(cell.config, cell.traffic, "cpu").filters.taps
        busy = union_seconds(data.device, *data.window)
        info.update(busy_s=busy, window_s=data.window_s)
        for m in cell.per_layer:
            value = cells.reader(m.name)(data)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        result["breakdown"] = breakdown(data)
    else:
        w, records, attempted = measure(run, seconds)
        print(f"window {w.elapsed:.3f} s, {w.images} images, {w.pixels} px; jobs (s): "
              + " ".join(f"{t:.3f}" for t in w.job_seconds), file=log)
    info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the program's state goes before the reference runs
    del run.engine
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, ref_de = judge(run, records)
    print(f"reference {time.perf_counter() - t_ref:.3f} s over {len(records)} images", file=log)
    correct, table = checks.verdict(numbers, cell.limits)

    if not trace:
        for m in cell.end_to_end:
            value = end_to_end(m.name, w, setup_s, ref_de, len(run.images))
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    for k, t in table.items():
        print(f"check {k} {t['value']!r} limit {t['limit']!r}", file=log)
    return {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
            "device": info, **result, "checks": table}


def end_to_end(name: str, w: Window, setup_s: float, ref_de: dict, n_images: int):
    """The end-to-end metric `name`. `delta_e.plugin` is `delta_e` of the
    plugin's schedule, under a bound of its own."""
    if name == "setup_s":
        return setup_s
    if name == "image_s":
        return w.seconds_per_image()
    if name == "image_s_p90":
        return percentile(w.image_seconds, 90)
    if name == "mpix_s":
        return w.mpix_per_s()
    if name in ("delta_e", "delta_e.plugin"):
        # over the cell's fixed image set, every image once
        return float(np.mean([ref_de[i] for i in sorted(ref_de)])) if len(ref_de) == n_images else None
    raise KeyError(f"no end-to-end metric {name!r}")
