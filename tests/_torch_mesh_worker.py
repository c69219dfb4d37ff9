"""Rank functions of the port's multi-device tests (not a pytest module).

`hybridquantization_tpu_torch.parallel.multihost.launch` starts them as
gloo ranks on the CPU, from tests/test_torch_mesh.py, tests/test_torch_batch.py
and tests/test_torch_cuda.py. They import torch, numpy and the port only,
never jax, and return numpy results, which the parent holds against the JAX
package and the one-device engine. The inputs are made from numpy seeds by
the functions below, the same in every rank and in the parent.

Shapes: every shard's H x W x 3 is a multiple of 32 elements. torch's CPU
pow rounds an element by its position within a vector loop, so with that
size a member's numbers do not depend on which members share its call
(pipelined against batched, a pop rank's slice against the whole
population).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import colorspace as cs
from hybridquantization_tpu_torch.parallel import (
    PIXEL_AXIS,
    ShardedBatchQuantizer,
    conv1d_vertical_sharded,
    exchange_row_halos,
    make_mesh,
    make_strip_fitness,
    plan_fast,
    strip_scielab,
)
from hybridquantization_tpu_torch.parallel.fast import make_fast_fitness, shard_context
from hybridquantization_tpu_torch.parallel.mesh import row_sharding
from hybridquantization_tpu_torch.parallel.sharded import pad_rows, row_plan
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import stacked_kernels
from hybridquantization_tpu_torch.synth import natural_image

HALO = 4        # half-width of the plain halo and vertical-conv checks (9 taps)
ODD_H = 41      # a height no pixel axis divides: padded and masked (h_valid)
COL_HW = (72, 256)  # JAX's own column plan is feasible at 2 and 4 shards
WP = tuple(float(v) for v in cs.WHITEPOINT_D65)


def halo_input() -> np.ndarray:
    return np.random.default_rng(1).random((3, 64, 40), dtype=np.float32)


def conv_kernels() -> np.ndarray:
    return np.random.default_rng(2).random((3, 2 * HALO + 1), dtype=np.float32)


def row_image(h: int = 64) -> np.ndarray:
    return np.random.default_rng(3).random((h, 48, 3), dtype=np.float32)


def strip_palettes() -> np.ndarray:
    pals = np.random.default_rng(4).random((3, 5, 3), dtype=np.float32)
    pals[0, 4] = pals[0, 1]  # a duplicate entry: unused, penalised
    return pals


def col_image() -> np.ndarray:
    return np.random.default_rng(5).random((*COL_HW, 3), dtype=np.float32)


def col_palettes() -> np.ndarray:
    return np.random.default_rng(6).random((3, 6, 3), dtype=np.float32)


def engine_images() -> np.ndarray:
    return np.stack([natural_image(64, 80, seed=s) for s in (7, 8)])


def engine_config(**kw) -> QuantizationConfig:
    return QuantizationConfig(
        swasa=SWASAConfig(num_colors=4, population=2, imax=6), init="kmeans", seed=3, **kw
    )


# (data, pop, pixel) shapes
ENGINES = {"columns": ((1, 1, 2), "columns"), "rows": ((1, 1, 2), "rows"), "data": ((2, 1, 1), "auto")}
POP_MESHES = {"base": (1, 1, 2), "pop": (1, 2, 2)}


def mesh_of(shape, device="cpu"):
    """The mesh of a (data, pop, pixel) shape."""
    n_data, n_pop, n_pixel = shape
    return make_mesh(n_data, n_pixel, n_pop, device=device)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def row_checks(mesh) -> dict:
    """Halo exchange, vertical conv, strip S-CIELAB and strip fitness (with
    and without h_valid) on this rank's strip of a pixel line."""
    f = build_filters()
    kh, kv = stacked_kernels(f, False), stacked_kernels(f, True)
    out = {}
    x = halo_input()
    strip = _t(x[:, row_sharding(mesh, x.shape[1])])
    top, bottom = exchange_row_halos(strip, HALO, mesh)
    out["halo_top"], out["halo_bottom"] = _np(top), _np(bottom)
    out["conv_v"] = _np(conv1d_vertical_sharded(strip, _t(conv_kernels()), mesh))

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=5, population=3))
    img = _t(row_image())
    img_strip = img[row_sharding(mesh, img.shape[0])]
    target = strip_scielab(img_strip, kh, kv, WP, mesh)
    out["scielab"] = _np(target)
    err, use = make_strip_fitness(img_strip, target, kh, kv, WP, cfg, mesh)(_t(strip_palettes()))
    out["strip_err"], out["strip_use"] = _np(err), _np(use)

    odd = _t(row_image(ODD_H))
    H_pad = row_plan(ODD_H, mesh.size(PIXEL_AXIS), f.half_width)
    odd_strip = pad_rows(odd, H_pad)[row_sharding(mesh, H_pad)]
    odd_target = strip_scielab(odd_strip, kh, kv, WP, mesh)
    fit = make_strip_fitness(odd_strip, odd_target, kh, kv, WP, cfg, mesh, h_valid=ODD_H)
    err, use = fit(_t(strip_palettes()))
    out["hvalid_err"], out["hvalid_use"] = _np(err), _np(use)
    return out


def column_checks(mesh) -> dict:
    """The column-sharded fitness of this rank's shard, member-pipelined and
    batched."""
    f = build_filters()
    H, W = COL_HW
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=6, population=3))
    cols, ok = plan_fast(H, W, f.half_width, mesh.size(PIXEL_AXIS))
    assert ok
    ctx = shard_context(_t(col_image())[None], f, cfg, cols[mesh.index(PIXEL_AXIS)])
    out = {}
    for overlap in (True, False):
        fit = make_fast_fitness(ctx, dataclasses.replace(cfg, overlap_collectives=overlap), mesh, H=H, W=W)
        err, use = fit(_t(col_palettes())[None])
        out[f"col_err_{overlap}"], out[f"col_use_{overlap}"] = _np(err[0]), _np(use[0])
    return out


def engine_run(cfg: QuantizationConfig, shape, strategy: str, device="cpu") -> dict:
    """ShardedBatchQuantizer.run (k-means, polish 2) and error_images on
    engine_images() over a mesh of `shape`."""
    q = ShardedBatchQuantizer(cfg, mesh_of(shape, device), strategy=strategy)
    images = engine_images()
    out, info = q.run(images, polish_iters=2)
    de, viz = q.error_images(images, out)
    state = info["state"]
    return {
        "palettes": _np(info["palettes"]), "anneal_palettes": _np(q._gather(state.best_colors)),
        "best_errors": info["best_errors"], "current_errors": _np(q._gather(state.current_errors)),
        "telemetry": info["telemetry"]["best_error"], "out": _np(out), "de": _np(de), "viz": _np(viz),
    }


def rank_checks(rank: int, n: int) -> dict:
    """Every check of a group of n ranks (module doc), by name."""
    torch.manual_seed(0)
    line = make_mesh(1, n, 1, device="cpu")
    out = {"rows": row_checks(line), "columns": column_checks(line)}
    if n == 2:
        for name, (shape, strategy) in ENGINES.items():
            out[f"engine_{name}"] = engine_run(engine_config(), shape, strategy)
    if n == 4:
        for name, shape in POP_MESHES.items():
            mesh = mesh_of(shape)
            for strategy in ("rows", "columns"):
                if mesh.member:
                    q = ShardedBatchQuantizer(engine_config(), mesh, strategy=strategy)
                    pals, info = q.find_palettes(engine_images())
                    state = info["state"]
                    out[f"{name}_{strategy}"] = {
                        "palettes": _np(pals), "best_errors": info["best_errors"],
                        "current_errors": _np(state.current_errors),
                    }
        pop3 = dataclasses.replace(engine_config(), swasa=SWASAConfig(num_colors=4, population=3))
        try:
            ShardedBatchQuantizer(pop3, mesh_of((1, 2, 2)))
        except ValueError as e:
            out["indivisible"] = str(e)
        try:
            make_mesh(1, 2 * n, 1, device="cpu")
        except ValueError as e:
            out["too_few_ranks"] = str(e)
    return out


def cli_rank(rank: int, argv: list) -> None:
    """One process of a `quantize-batch --distributed` job on the CPU: the
    command joins the group itself (started without the launcher)."""
    from hybridquantization_tpu_torch.cli import main

    torch.set_num_threads(1)
    main([*argv, "--process-id", str(rank)], device="cpu")


def card_ranks(rank: int) -> dict:
    """Two gloo ranks sharing one card: the column-sharded engine on (1, 1,
    2), its fitness of fixed palettes, and the launches each rank made."""
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff

    cfg = engine_config()
    q = ShardedBatchQuantizer(cfg, mesh_of((1, 1, 2), "cuda"), strategy="columns")
    fitness = q._columns[0](torch.as_tensor(engine_images(), device=q.device))
    err, use = fitness(torch.as_tensor(np.stack([col_palettes()[:2, :4]] * 2), device=q.device))
    before = (ak.assign_opp_usage_pop.launches, ff.fused_scielab_err_sums.slab_launches)
    pals, info = q.find_palettes(engine_images())
    launches = (ak.assign_opp_usage_pop.launches - before[0], ff.fused_scielab_err_sums.slab_launches - before[1])
    return {"err": _np(err), "use": _np(use), "palettes": _np(pals), "best_errors": info["best_errors"],
            "launches": launches, "device": str(q.device)}
