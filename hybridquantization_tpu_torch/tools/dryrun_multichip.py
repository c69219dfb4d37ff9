"""Dry run of the multi-device engine at tiny shapes.

Counterpart of `__graft_entry__.dryrun_multichip`: n ranks
(parallel.multihost.launch) run, each section on its own mesh,

  1. the row-sharded engine on a (data, 1, pixel) mesh (data parallelism
     over a batch, halo exchange in the S-CIELAB filter): find_palettes and
     quantize;
  2. the column-sharded engine (parallel.fast: B1 and B2s per shard, guard
     exchanges) on a (data, 1, pixel) mesh with k-means starts, LAB
     assignment, Lloyd polish and error images;
  3. with four ranks or more, the population axis: (1, 2, n / 2), rows.

Every rank must end with the same results; rank 0 prints one line a
section.

    python -m hybridquantization_tpu_torch.tools.dryrun_multichip [ranks] [--cpu]

It runs on "cuda" (NCCL, one card per rank) unless the caller asks for the
CPU (gloo).
"""

from __future__ import annotations

import sys

import numpy as np


def _factor(n: int) -> tuple[int, int]:
    """(data, pixel) with data in (2, 4, 3) where pixel stays >= 2, else 1."""
    for cand in (2, 4, 3):
        if n % cand == 0 and n // cand >= 2:
            return cand, n // cand
    return 1, n


def _dryrun_rank(rank, n, device) -> dict:
    from .. import QuantizationConfig, SWASAConfig
    from ..parallel import ShardedBatchQuantizer, make_mesh, plan_fast

    rng = np.random.default_rng(0)
    lines, out = [], {}
    n_data, n_pixel = _factor(n)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=8, population=2, imax=2), progress_every=2)
    q = ShardedBatchQuantizer(cfg, make_mesh(n_data, n_pixel, 1, device), strategy="rows")
    H = max(q.filters.half_width, 12) * n_pixel
    images = rng.random((n_data, H, 32, 3), dtype=np.float32)
    palettes, info = q.find_palettes(images, chunk_size=2)
    quant = q.quantize(images, palettes)
    assert np.isfinite(info["best_errors"]).all() and quant.shape == images.shape
    out["rows"] = info["best_errors"]
    lines.append(f"dryrun_multichip OK: mesh {n_data}x{n_pixel} rows, batch {n_data}, image {H}x32, "
                 f"best errors {info['best_errors'].tolist()}")

    n_pix_f = max(n // 2, 1)
    n_dat_f = n // n_pix_f
    Hf, Wf = 64, 130 * n_pix_f
    assert plan_fast(Hf, Wf, q.filters.half_width, n_pix_f)[1], (Hf, Wf, n_pix_f)
    cfg_f = QuantizationConfig(swasa=SWASAConfig(num_colors=6, population=2, imax=2), progress_every=2,
                               init="kmeans", assignment_space="lab")
    qf = ShardedBatchQuantizer(cfg_f, make_mesh(n_dat_f, n_pix_f, 1, device), strategy="columns")
    imgs2 = rng.random((n_dat_f, Hf, Wf, 3), dtype=np.float32)
    out2, info2 = qf.run(imgs2, polish_iters=2)
    de2, _ = qf.error_images(imgs2, out2)
    assert np.isfinite(info2["best_errors"]).all() and out2.shape == imgs2.shape
    out["columns"] = np.concatenate([info2["best_errors"], de2.cpu().numpy()])
    lines.append(f"dryrun_multichip fast path OK: mesh {n_dat_f}x{n_pix_f} columns (kmeans init, lab "
                 f"assignment, polish, error images), image {Hf}x{Wf}, best errors "
                 f"{info2['best_errors'].tolist()}, error-image deltaE {de2.tolist()}")

    if n >= 4:
        n_pix_p = n // 2
        cfg_p = QuantizationConfig(swasa=SWASAConfig(num_colors=6, population=2, imax=2), progress_every=2)
        qp = ShardedBatchQuantizer(cfg_p, make_mesh(1, n_pix_p, 2, device), strategy="rows")
        imgs3 = rng.random((1, max(qp.filters.half_width, 12) * n_pix_p, 24, 3), dtype=np.float32)
        _, info3 = qp.find_palettes(imgs3, chunk_size=2)
        assert np.isfinite(info3["best_errors"]).all()
        out["pop"] = info3["best_errors"]
        lines.append(f"dryrun_multichip pop axis OK: mesh 1x2x{n_pix_p} (population sharded over 'pop'), "
                     f"best errors {info3['best_errors'].tolist()}")
    if rank == 0:
        print("\n".join(lines), flush=True)
    return out


def dryrun_multichip(n_ranks: int, device="cuda") -> list[dict]:
    """Run the sections above on n_ranks ranks; raises unless every rank
    finished with the same results. Returns each rank's results."""
    from ..parallel.multihost import launch

    results = launch(_dryrun_rank, n_ranks, (n_ranks, str(device)), device=device)
    for r in results[1:]:
        for k, v in r.items():
            if not np.array_equal(v, results[0][k]):
                raise RuntimeError(f"dryrun_multichip: the ranks disagree on {k}")
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(next((a for a in argv if a.isdigit()), 2))
    dryrun_multichip(n, "cpu" if "--cpu" in argv else "cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
