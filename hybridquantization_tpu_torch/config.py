"""Configuration dataclasses — the same surface as the JAX package.

Field names and defaults equal `hybridquantization_tpu/config.py` field for
field (`tests/test_torch_config.py` holds them equal), so one configuration
describes a run in either package. The reference's GUI parameters and their
defaults are documented there (HybridQuantization.java:185-257).

`precision` "highest" and "f32x3" (the TPU's two f32-grade matmul modes)
both mean fp32 here: the assignment scores and the S-CIELAB filter run in
plain fp32 on the GPU. "bf16" is the TPU's single-pass DEFAULT dot: every
operand is rounded to bf16 (round to nearest even), each product is exact
in f32 and the products accumulate in f32. `conv_precision` ("" = follow
`precision`) sets the S-CIELAB filter's mode on its own.
`overlap_collectives` steers the column-sharded engine's evaluation
(parallel.fast.make_fast_fitness): member-pipelined, each member's
collective started before the next member's kernels (True), or the
population in one launch of each kernel and one collective (False); both
give identical values. `use_pallas` steers a TPU-only code path and is
accepted and ignored.
"""

from __future__ import annotations

import dataclasses

DELTA_E_KINDS = ("CIE76", "CIE94", "CIEDE2000")
ASSIGNMENT_SPACES = ("srgb", "lab")
PRECISIONS = ("highest", "f32x3", "bf16")
TIE_MODES = ("first", "average")
INITS = ("random", "kmeans")


@dataclasses.dataclass(frozen=True)
class SWASAConfig:
    """Annealing parameters (HybridQuantization.java:196-225)."""

    num_colors: int = 8          # palette size K            (:192)
    population: int = 4          # candidate palettes        (:197)
    imax: int = 5000             # max iterations            (:199)
    delta: float = 2.0           # unused-color penalty      (:201)
    convergence: bool = True     # population convergence    (:204)
    conv_delay: float = 0.75     # convergence delay         (:206)
    conv_spread: float = 0.15    # convergence spread        (:208)
    t0: float = 20.0             # initial temperature       (:212)
    i_tc: int = 20               # iterations per temp step  (:214)
    alpha: float = 0.9           # cooling coefficient       (:216)
    s0: float = 100.0            # initial max step width    (:223)
    beta: float = 5.3            # step-width adaptation     (:224)


@dataclasses.dataclass(frozen=True)
class ScielabConfig:
    """Human-visual-system model parameters (HybridQuantization.java:228-235)."""

    dpi: int = 72                      # screen dpi          (:229)
    viewing_distance_cm: float = 45.0  # viewing distance    (:231)
    whitepoint: str = "D65"            # D65 | D50           (:233)


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Full engine configuration (see the JAX package for each field)."""

    swasa: SWASAConfig = SWASAConfig()
    scielab: ScielabConfig = ScielabConfig()
    deltaE: str = "CIE76"
    assignment_space: str = "srgb"
    precision: str = "f32x3"      # "highest" | "f32x3" (both fp32 here) | "bf16"
    tie_mode: str = "first"       # "first" | "average"
    conv_precision: str = ""      # "" (= precision) | "highest" | "f32x3" | "bf16"
    init: str = "random"          # "random" | "kmeans"
    verbose: bool = False
    seed: int = 0
    progress_every: int = 10
    use_pallas: str = "auto"      # TPU only; ignored
    overlap_collectives: bool = True  # member-pipelined column-sharded fitness

    def __post_init__(self):
        _check_choice("deltaE", self.deltaE, DELTA_E_KINDS)
        _check_choice("assignment_space", self.assignment_space, ASSIGNMENT_SPACES)
        _check_choice("precision", self.precision, PRECISIONS)
        _check_choice("conv_precision", self.conv_precision, ("",) + PRECISIONS)
        _check_choice("tie_mode", self.tie_mode, TIE_MODES)
        _check_choice("init", self.init, INITS)


def _check_choice(name: str, value, options) -> None:
    if value not in options:
        raise ValueError(f"unknown {name} {value!r}; options: {list(options)}")
