"""The plain reference against the program's plain CPU path at small
sizes, and the TF32 rounding of its control."""

from __future__ import annotations

import pytest
import torch

from benchmark.reference import palette, scielab
from benchmark.reference.filters import build_filters
from benchmark.reference.precision import F64, TF32, tf32_round
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import colorspace as cs
from hybridquantization_tpu_torch.ops import assign as port_assign
from hybridquantization_tpu_torch.pipeline import _make_context, make_fitness
from hybridquantization_tpu_torch.scielab import transform as port_sct
from hybridquantization_tpu_torch.scielab.filters import build_filters as port_filters
from hybridquantization_tpu_torch.synth import natural_image


@pytest.fixture(scope="module")
def image():
    return natural_image(48, 64, 3)


def test_scielab_matches_the_program(image):
    ref = scielab.srgb_to_scielab(torch.from_numpy(image), build_filters(), "D65", F64)
    port = port_sct.srgb_to_scielab(torch.from_numpy(image), port_filters(), cs.WHITEPOINT_D65)
    assert float((ref - port.double()).abs().max()) < 2e-4


@pytest.mark.parametrize("K", [4, 16])
def test_fitness_matches_the_program(image, K):
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K))
    pal = torch.rand((K, 3), generator=torch.Generator().manual_seed(K))
    ctx = _make_context(torch.from_numpy(image), port_filters(), cfg, "cpu")
    port = float(make_fitness(ctx, cfg)(pal)[0])
    target = scielab.srgb_to_scielab(torch.from_numpy(image), build_filters(), "D65", F64)
    ref = palette.fitness(torch.from_numpy(image), pal, target, build_filters(), "D65", 2.0, "CIE76", F64)
    assert abs(port - ref) / ref < 1e-5


def test_quantize_matches_the_program(image):
    pal = torch.rand((32, 3), generator=torch.Generator().manual_seed(1))
    port = port_assign.quantize_image(torch.from_numpy(image), pal)
    ref = palette.quantize(torch.from_numpy(image), pal, F64)
    assert float((port.double() - ref).abs().max()) == 0.0
    assert palette.quantize_gap(image, port, pal) < 1e-6
    off = port.clone()
    off[3, 4] = pal[(int(palette.nearest(port[3, 4][None], pal, F64)) + 1) % 32]
    assert palette.quantize_gap(image, off, pal) > 1e-4
    off[3, 4] = 0.123
    assert palette.quantize_gap(image, off, pal) == float("inf")


@pytest.mark.parametrize("h,w,method", [(48, 64, "exact"), (1024, 1024, "hist")])
def test_polish_matches_the_program(h, w, method):
    img = natural_image(h, w, 4).reshape(-1, 3)
    pal = torch.rand((16, 3), generator=torch.Generator().manual_seed(2))
    port = port_assign.polish_palette(torch.from_numpy(img), pal, "srgb", cs.WHITEPOINT_D65, 5, method=method)
    ref = palette.polish(torch.from_numpy(img), pal, 5, F64)
    assert float((port.double() - ref).abs().max()) < 1e-5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159, 0.0, 1e-3])
    r = tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                       # a tie goes to even
    assert r[3] == 1.0 + 2**-9               # ... and up to even
    m, _ = torch.frexp(r)
    assert torch.equal(m * 2**11, torch.round(m * 2**11))
    assert float((r - x).abs().max() / x.abs().max()) < 2**-11
    assert TF32.operand(x).dtype == torch.float32 and F64.operand(x) is x
