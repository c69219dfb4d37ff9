"""Whether what the timed path returned is correct: each image's outputs
held to the plain reference (`reference/`), number by number.

For every sampled image the reference works out again, from the image
alone, its S-CIELAB; from the search's palette (the program's answer of
that stage, as a served model's tokens are), that palette's fitness and
its Lloyd polish; and it judges the returned quantized image against the
returned palette, and the mean Delta-E and error image against its own of
the returned quantized image. The numbers, each the worst over the images
checked:

- `fitness_rel`: |reported fitness - reference's| / reference's;
- `palette_median_abs`: the median over the polished palette's entries of
  an entry's largest channel gap (sRGB). Not the largest: a histogram bin
  that lies within rounding of two entries goes to either, and moves a
  light entry by up to 1e-2 in fp32 and fp64 alike, after which the two
  Lloyd trajectories part for the few entries near it; the median entry
  stays within rounding, and moves by 1e-4 and more once every score
  is rounded to TF32;
- `quantize_gap`: the widest squared-sRGB gap by which an output pixel
  lies farther from its source than the palette's nearest entry (infinite
  where it is no entry);
- `delta_e_rel`: |reported mean Delta-E - reference's| / reference's;
- `error_image_abs`: the largest gap of an error-image pixel (of each
  channel, where the job keeps all three).

The control (`control_record`) is the reference itself in TF32 put in
the program's place after the search, and has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

from .record import Record
from .reference import color, palette, scielab
from .reference.filters import build_filters
from .reference.precision import F64, TF32, Precision


class Judge:
    """The reference for one configuration and traffic mix, on `device`."""

    def __init__(self, config: dict, traffic: dict, device):
        eng = config["engine"]
        sc = eng["scielab"]
        self.filters = build_filters(sc["dpi"], sc["viewing_distance_cm"])
        self.whitepoint = sc["whitepoint"]
        self.kind = eng["deltaE"]
        self.delta = eng["swasa"]["delta"]
        self.polish_iters = traffic.get("polish", 0)
        self.error_image = bool(traffic.get("error_image"))
        self.device = torch.device(device)
        if eng["assignment_space"] != "srgb":
            raise ValueError("the reference assigns in sRGB only")

    def _img(self, image: np.ndarray, prec: Precision) -> torch.Tensor:
        return prec.cast(torch.from_numpy(image).to(self.device))

    def target(self, image: np.ndarray, prec: Precision = F64) -> torch.Tensor:
        return scielab.srgb_to_scielab(self._img(image, prec), self.filters, self.whitepoint, prec)

    def error(self, target_lab: torch.Tensor, quantized, prec: Precision = F64) -> torch.Tensor:
        q = scielab.srgb_to_scielab(prec.cast(torch.as_tensor(quantized).to(self.device)),
                                    self.filters, self.whitepoint, prec)
        return color.delta_e(target_lab, q, self.kind)

    def numbers(self, image: np.ndarray, rec: Record) -> tuple[dict, float]:
        """(the numbers of one image, the reference's mean Delta-E of the
        returned quantized image)."""
        target = self.target(image)
        img = self._img(image, F64)
        ref_fit = palette.fitness(img, rec.anneal_palette, target, self.filters, self.whitepoint,
                                  self.delta, self.kind, F64)
        out = {"fitness_rel": abs(rec.fitness - ref_fit) / ref_fit}
        if self.polish_iters:
            pal = palette.polish(img, torch.from_numpy(rec.anneal_palette), self.polish_iters, F64)
            gap = (torch.from_numpy(rec.palette).to(pal) - pal).abs().amax(dim=1)
            out["palette_median_abs"] = float(torch.quantile(gap, 0.5))
        out["quantize_gap"] = palette.quantize_gap(img, torch.from_numpy(rec.quantized).to(self.device),
                                                   torch.from_numpy(rec.palette))
        e = self.error(target, rec.quantized)
        ref_de = float(e.mean())
        if self.error_image:
            out["delta_e_rel"] = abs(rec.mean_de - ref_de) / ref_de
            viz = torch.as_tensor(rec.viz).to(self.device, torch.float64)
            ref = (255.0 - e) ** 2 / 255.0**2
            ref = ref[..., None] if viz.dim() == 3 else ref  # every channel of a whole error image
            out["error_image_abs"] = float((viz - ref).abs().max())
        return out, ref_de

    def control_record(self, image: np.ndarray, rec: Record) -> Record:
        """The program's outputs after the search, made by the reference in
        TF32 from the same image and search palette."""
        img = self._img(image, TF32)
        target = self.target(image, TF32)
        fit = palette.fitness(img, rec.anneal_palette, target, self.filters, self.whitepoint,
                              self.delta, self.kind, TF32)
        pal = TF32.cast(torch.from_numpy(rec.anneal_palette).to(self.device))
        if self.polish_iters:
            pal = palette.polish(img, pal, self.polish_iters, TF32)
        quant = palette.quantize(img, pal, TF32)
        mean_de = viz = None
        if self.error_image:
            e = self.error(target, quant, TF32)
            mean_de, viz = float(e.mean()), (255.0 - e) ** 2 / 255.0**2
        return Record(rec.index, rec.anneal_palette, fit, pal.cpu().numpy(), quant.cpu().numpy(),
                      mean_de, viz)


def worst(per_image: list[dict]) -> dict:
    """Each number's worst reading over the images (NaN counts as worst)."""
    out: dict[str, float] = {}
    for numbers in per_image:
        for k, v in numbers.items():
            v = float("inf") if v != v else v
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at most its limit;
    a number without a limit is not correct."""
    table = {k: {"value": v, "limit": limits.get(k, {}).get("limit")} for k, v in numbers.items()}
    ok = bool(numbers) and all(t["limit"] is not None and t["value"] <= t["limit"] for t in table.values())
    return ok, table
