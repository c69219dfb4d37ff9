"""The TPU engine's f32x3 population fitness, emulated on the card.

The JAX engine's default `precision="f32x3"` scores each pixel against each
palette entry with a hi/lo bf16 split that drops the lo x lo term
(`hybridquantization_tpu/ops/pallas_assign.py:171-185`), takes the first
index of the max, and gathers the winner's opponent colour exactly from a
3-way bf16 split (`:279-287`). The port's engine pins fp32 scores instead
(B1, `ops/assign_kernel.py`). `split_assign` (`ops/probe_kernels.py`, T4's
kernel) computes the TPU's function: the 12 exact products of the split
summed on the tensor cores, first-index ties, `opp_parts=3`.

`make_split_population_fitness(ctx, cfg, conv)` has the contract of
`pipeline.make_population_fitness` with B1 replaced by `split_assign`:
operands from `probe_kernels.pack_palette` and the pixels' (4, P) pack, one
image, sRGB assignment. `conv` picks B2's arithmetic: "fp32", the engine's
B2 at the config's conv precision (fp32 at the default f32x3), or "split",
B2's split mode (`ops/fused_fitness.py`, precision "split"), the TPU
kernel's own f32x3 conv: hi/lo bf16 products without lo x lo and the
horizontal pass's output kept as a hi/lo pair
(`hybridquantization_tpu/ops/fused_fitness.py:369-393`, `:388-392`). With conv "split" the whole TPU fitness is emulated:
split_assign at f32x3, then B2 at f32x3. On a CUDA context both launch
their kernels, on a CPU context their plain versions run
(`split_assign_reference`, `fused_scielab_err_sums_reference`); a failed
build or launch raises. It is a diagnostic of fault C2 (ROADMAP §C),
reached from `chip_draws.py --fitness split|f32x3|xla`, `chip_c2.py` and
this module's layer-2 run, never from the engine, whose parity path stays
fp32.

`make_xla_population_fitness(ctx, cfg)` is the fitness of JAX's other
branch, the one it runs off the TPU (`use_pallas="auto"` on a CPU or GPU):
its assignment at f32x3 is not the Pallas kernel's but
`hybridquantization_tpu/ops/assign.py:_scores` (`:54-61`): three bf16
dots hi.hi + hi.lo + lo.hi of the 3 features, then 2 * dots - |c|^2 with
the bias in f32 (`xla_f32x3_index`, plain torch on either device: no TPU
kernel computes it); then the engine's B2 in fp32. It flips a few pixels
of a palette against the f64 nearest entry, where the engine's fp32
scores flip next to none (`tests/jax_cpu_xla_scores.py`), and it is the
function `tests/jax_cpu_engine.py --branch xla` anneals, to within B2's
fp32 summation.

Layer 2 with the emulated fitness (`fitness_parity`'s protocol, lines and
flags; the flips are split_assign's own index for member 0 against the
oracle's):
  python -m hybridquantization_tpu_torch.tools.tpu_f32x3 --content natural
      --size 512 --colors 16 [--conv fp32|split] [--palettes 12] [--cpu]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from .. import colorspace as cs
from ..ops import probe_kernels as pk
from ..ops.fused_fitness import fused_scielab_err_sums
from ..swasa import schedule
from . import pack_pixels

#: the TPU's gather: hi + mid + lo bf16 parts, the f32 colour exactly
OPP_PARTS = 3
#: B2's arithmetic in the emulation: the engine's (fp32) or the TPU's f32x3
CONVS = ("fp32", "split")


def _check(ctx: dict, cfg) -> None:
    if cfg.assignment_space != "srgb":
        raise ValueError(f"the f32x3 emulation assigns in sRGB, not {cfg.assignment_space!r}")
    if cfg.tie_mode != "first":
        raise ValueError(f"the f32x3 emulation takes first-index ties, not {cfg.tie_mode!r}")
    if ctx["target_lab"].dim() != 3:
        raise ValueError("the f32x3 emulation takes one image, not a batch context")


def split_assign_pop(x4: torch.Tensor, palettes: torch.Tensor, *, return_index: bool = False):
    """split_assign of the (4, P) pixels against (pop, K, 3) sRGB palettes:
    (opp (pop, 3, P), counts (pop, K) int32[, idx (pop, P) int32])."""
    c4, o4 = pk.pack_palette(palettes, cs.srgb_to_opp(palettes))
    return pk.split_assign(x4, c4, o4, tie_mode="first", opp_parts=OPP_PARTS,
                           return_index=return_index)


def make_split_population_fitness(ctx: dict, cfg, conv: str = "fp32"):
    """(pop, K, 3) sRGB palettes -> ((pop,) errors, (pop, K) bool usage):
    `split_assign` at f32x3 (first-index ties, the exact 3-part gather),
    then B2 at `cfg.conv_precision` or else `cfg.precision` (conv "fp32")
    or in its split mode (conv "split"), then sums / (H*W) + delta *
    #unused, as JAX's Pallas branch."""
    _check(ctx, cfg)
    if conv not in CONVS:
        raise ValueError(f"unknown conv {conv!r}; options: {list(CONVS)}")
    H, W = ctx["target_lab"].shape[:2]
    x4 = pack_pixels(ctx["assign_pixels"])
    conv_precision = "split" if conv == "split" else cfg.conv_precision or cfg.precision

    def pop_fitness(palettes: torch.Tensor):
        opp, counts = split_assign_pop(x4, palettes)
        sums = fused_scielab_err_sums(
            opp.reshape(palettes.shape[0], 3, H, W), ctx["target_planar"], ctx["kh"], ctx["kv"],
            ctx["whitepoint"], cfg.deltaE, precision=conv_precision, taps_on_host=ctx["taps_on_host"],
        )
        usage = counts > 0
        return sums / (H * W) + schedule.unused_penalty(usage, cfg.swasa.delta), usage

    return pop_fitness


def xla_f32x3_index(pixels: torch.Tensor, palette: torch.Tensor, block: int = 1 << 16) -> torch.Tensor:
    """(P,) int64 index of the first max of JAX's XLA-branch scores at
    precision "f32x3" for (P, 3) pixels and a (K, 3) palette: each operand
    split into bf16 hi and lo, dots = (hi.hi + hi.lo) + lo.hi with each dot
    summed over the features in order (every product is exact in f32), then
    2 * dots - |c|^2, with |c|^2 = fma(c2, c2, fma(c1, c1, c0 * c0)) as
    XLA's CPU compiler contracts `jnp.sum(palette * palette, -1)` (each fma
    from the exact f64 product), in blocks of `block` pixels."""

    def split(x):
        hi = x.to(torch.bfloat16).to(torch.float32)
        return hi, (x - hi).to(torch.bfloat16).to(torch.float32)

    def dot(a, b):
        return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]) + a[:, None, 2] * b[None, :, 2]

    ch, cl = split(palette)
    c = palette.double()
    bias = (c[:, 0] * c[:, 0]).float()
    for f in (1, 2):
        bias = (c[:, f] * c[:, f] + bias.double()).float()
    out = []
    for x in pixels.split(block):
        xh, xl = split(x)
        dots = (dot(xh, ch) + dot(xh, cl)) + dot(xl, ch)
        out.append(torch.argmax(2.0 * dots - bias[None, :], dim=-1))
    return torch.cat(out)


def make_xla_population_fitness(ctx: dict, cfg):
    """(pop, K, 3) sRGB palettes -> ((pop,) errors, (pop, K) bool usage):
    `xla_f32x3_index` per member, the winner's opponent colour, then the
    engine's B2 in fp32, sums / (H*W) + delta * #unused: JAX's fitness off
    the TPU (`make_population_fitness` without Pallas) at f32x3."""
    _check(ctx, cfg)
    H, W = ctx["target_lab"].shape[:2]
    K = cfg.swasa.num_colors

    def pop_fitness(palettes: torch.Tensor):
        idx = torch.stack([xla_f32x3_index(ctx["assign_pixels"], p) for p in palettes])
        opp = torch.gather(cs.srgb_to_opp(palettes), 1, idx[..., None].expand(-1, -1, 3))
        sums = fused_scielab_err_sums(
            opp.transpose(1, 2).reshape(palettes.shape[0], 3, H, W).contiguous(), ctx["target_planar"],
            ctx["kh"], ctx["kv"], ctx["whitepoint"], cfg.deltaE, precision=cfg.conv_precision or cfg.precision,
            taps_on_host=ctx["taps_on_host"],
        )
        usage = torch.stack([torch.bincount(i, minlength=K)[:K] > 0 for i in idx])
        return sums / (H * W) + schedule.unused_penalty(usage, cfg.swasa.delta), usage

    return pop_fitness


def split_engine_fitness(img: np.ndarray, cfg, device, conv: str = "fp32"):
    """`fitness_parity.engine_fitness` with the emulated fitness (B2 by
    `conv`): numpy (pop, K, 3) palettes -> (numpy (pop,) errors, (P,) int32
    split_assign index of member 0)."""
    from ..pipeline import _make_context
    from ..scielab.filters import build_filters

    ctx = _make_context(img, build_filters(cfg.scielab.dpi, cfg.scielab.viewing_distance_cm),
                        cfg, device)
    fit = make_split_population_fitness(ctx, cfg, conv)
    x4 = pack_pixels(ctx["assign_pixels"])

    def evaluate(pals: np.ndarray):
        p = torch.as_tensor(pals, device=device)
        errors, _ = fit(p)
        _, _, idx = split_assign_pop(x4, p[:1], return_index=True)
        return errors.cpu().numpy(), idx[0].cpu().numpy()

    return evaluate


def main(argv=None, *, device="cuda") -> int:
    """Layer 2 (`fitness_parity`'s protocol and flags) with the emulated
    fitness, B2 by `--conv`."""
    from . import fitness_parity

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--conv", default="fp32", choices=CONVS)
    args, rest = ap.parse_known_args(argv)
    print(f"fitness: split_assign at f32x3, then B2 conv {args.conv}", flush=True)
    return fitness_parity.main(rest, device=device,
                               evaluator=functools.partial(split_engine_fitness, conv=args.conv))


if __name__ == "__main__":
    raise SystemExit(main())
