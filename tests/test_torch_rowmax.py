"""split_rowmax's bf16 output is the bf16 rounding of its f32 output, on the CPU.

The kernel (max mode of `csrc/split_assign.cu`) rounds each pixel's f32
maximum once, where the TPU probe and the plain version round every score:
rounding to nearest (ties to even) is monotone, so the max of the rounded
scores is the rounding of the max, and a NaN score (dropped by both) or an
all-NaN row (-inf) changes nothing. These tests pin that identity on the
plain version, on inputs built to reach its corners: rows whose scores are
all NaN, a few NaN scores, exact ties (duplicate candidates, and maxima that
lie exactly halfway between two bf16 values, of both signs), and scores at
+0 and -0. `==` compares, so +0 and -0 are equal.
"""

import numpy as np
import pytest
import torch

from hybridquantization_tpu_torch.ops import probe_kernels as pk
from hybridquantization_tpu_torch.ops.assign_kernel import bf16_round

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

P, K, POP = 1000, 77, 3


def _inputs(run, case, seed):
    """x4 (4, P) and candidates (pop, 4, K), or (pop, ceil(P / run), 4, K),
    with the corner `case` planted, and the pixels it was planted on."""
    g = np.random.default_rng(seed)
    x4 = g.standard_normal((4, P)).astype(np.float32)
    shape = (POP, 4, K) if run is None else (POP, -(-P // run), 4, K)
    c = g.standard_normal(shape).astype(np.float32)
    rows = np.arange(5, P, 97)  # one or more pixels in every run
    if case == "nan_rows":
        x4[:, rows] = np.nan  # every score of these pixels is NaN
    elif case == "nan_scores":
        c[..., 0, [3, 40, K - 1]] = np.nan  # these candidates score NaN on every pixel
    elif case == "ties":
        c[..., 9] = c[..., 2]  # duplicate candidates: equal scores
        c[..., K - 1] = c[..., 0]
        # pixels (+-1, 0, 0, 0) score +-c[0, k] exactly; c[0, k] = +-(1 + odd / 256)
        # lies halfway between two bf16 values, so the maxima round to even
        sign = np.where(g.random(c[..., 0, :].shape) < 0.5, -1.0, 1.0)
        c[..., 0, :] = sign * (1.0 + (2 * g.integers(0, 64, c[..., 0, :].shape) + 1) / 256.0)
        x4[:, rows] = 0.0
        x4[0, rows] = np.where(np.arange(rows.size) % 2 == 0, 1.0, -1.0)
    elif case == "zeros":
        x4[:, rows] = 0.0  # every score +0 or -0
        x4[:, rows[::2]] = -0.0
        c[..., 0, :5] = -np.abs(c[..., 0, :5])  # products at -0
    return torch.from_numpy(x4), torch.from_numpy(c), torch.from_numpy(rows)


@pytest.mark.parametrize("run", [None, 128, 100])
@pytest.mark.parametrize("case", ["nan_rows", "nan_scores", "ties", "zeros"])
def test_bf16_row_max_is_the_rounded_f32_row_max(run, case):
    x4, c, rows = _inputs(run, case, 7 + (run or 0))
    f32 = pk.split_rowmax_reference(x4, c, run=run)
    bf = pk.split_rowmax_reference(x4, c, run=run, out_bf16=True)
    assert not bool(torch.isnan(bf).any()) and not bool(torch.isnan(f32).any())
    assert bool((bf == bf16_round(f32)).all())
    assert bool((pk.split_rowmax(x4, c, run=run, out_bf16=True) == bf).all())
    at = bf[:, rows]
    if case == "nan_rows":
        assert bool((at == float("-inf")).all()) and bool((f32[:, rows] == float("-inf")).all())
    elif case == "ties":
        # halfway maxima: the f32 max is no bf16 value, its rounding is
        # one, with an even last mantissa bit (ties to even)
        assert bool((f32[:, rows] != bf16_round(f32[:, rows])).all())
        assert bool((at.abs() >= 1.0).all())
        bits = (at.view(torch.int32) >> 16) & 1
        assert bool((bits == 0).all())
    elif case == "zeros":
        assert bool((at == 0.0).all())
