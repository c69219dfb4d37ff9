"""The port's multi-device tools on gloo CPU ranks: the dry run
(`tools.dryrun_multichip`, the counterpart of
`__graft_entry__.dryrun_multichip`) and the scaling rows of
`tools.bench_multichip.measure_scaling`."""

import numpy as np
import torch

from hybridquantization_tpu_torch.tools import bench_multichip, dryrun_multichip

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py


def test_dryrun_multichip_on_two_ranks(capfd):
    results = dryrun_multichip.dryrun_multichip(2, device="cpu")
    text = capfd.readouterr().out
    assert "dryrun_multichip OK: mesh 1x2 rows" in text
    assert "dryrun_multichip fast path OK: mesh 2x1 columns" in text
    assert len(results) == 2 and set(results[0]) == {"rows", "columns"}
    assert all(np.isfinite(v).all() for v in results[0].values())


def test_measure_scaling_rows():
    logged = []
    rows = bench_multichip.measure_scaling([1, 2, 8], 24, 64, colors=6, population=2, iters=2, reps=1,
                                           log=logged.append, device="cpu")
    assert [r["pixel_shards"] for r in rows] == [1, 2]
    assert logged[-1] == "shards=8: column plan infeasible, skipped"
    assert rows[0]["iter_ms"] > 0 and set(rows[1]) >= {"speedup_vs_1", "scaling_efficiency"}
    assert rows[1]["scaling_efficiency"] == rows[1]["speedup_vs_1"] / 2
