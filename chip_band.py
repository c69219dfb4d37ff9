#!/usr/bin/env python3
"""How close B2's split mode on the tensor cores (`csrc/band_fitness.cu`)
comes to its plain version, and why not closer: one GPU.

    python3 chip_band.py [--out band.json] [--root PATH]

1. The tensor cores' f32 sums: a probe kernel (one wgmma m64n32k16 of bf16
   operands, through csrc/wgmma.cuh, built with nvcc into a temporary
   directory) on 96 random cases of 64 x 32 sums, with exponent spreads up
   to 2^30, signed and unsigned, with and without an accumulator. It counts
   the sums equal to the model that band_fitness.cu is built on (every term
   chopped toward zero to 2^(emax - 25), emax the largest of the products'
   exponent sums e_a + e_b and the accumulator's exponent; the chopped
   terms summed exactly; the sum rounded toward zero to f32), and, for
   comparison, to the exact sum rounded to nearest.
2. The order of the sums: on the input of chip_smoke.py's phase_b2_split
   (B1's winners for the 4K natural frame, seed 0, random palettes, seed 1,
   population 4), the whole frame and its twenty 768 x 512 crops (each an
   image of its own), each member's Delta-E sum of
     kernel  the tensor-core kernel (CIE76),
     exact   the split's exact products summed in float64, rounded once to
             f32 per pass,
     tpu     the TPU kernel's order: its three dots, each summed over the
             taps in f32, then added,
   relative to the plain split (`fused_scielab_err_sums_reference`, which
   adds each tap's three products in ascending order), and the kernel
   relative to exact; and how many (crop, member) pairs part from the plain
   split by more than chip_smoke.B2_SPLIT_RTOL.

--root names the checkout whose package runs part 2 (as chip_ab.py takes
one; a parent checkout's split kernel then is the one held); part 1
always builds against this checkout's csrc/wgmma.cuh. Prints the card's
name and power limit, a line per crop, then one JSON line (also written to
--out). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

PROBE = r"""
#include <cuda_bf16.h>
#include <stdint.h>
#include "wgmma.cuh"
using namespace hq;
// one case a block: D = C + A B, A (64 x 16) from registers, B (16 x 32) from shared memory
__global__ void probe(const uint16_t* A, const uint16_t* B, const float* C, float* D) {
  __shared__ __align__(128) uint16_t bs[16 * 32];
  const int cs = blockIdx.x;
  const uint16_t* a = A + (size_t)cs * 64 * 16;
  for (int i = threadIdx.x; i < 16 * 32; i += 128) {
    const int k = i / 32, n = i % 32;
    bs[((n / 8) * 256 + (k / 8) * 128 + (n % 8) * 16 + (k % 8) * 2) / 2] = B[(size_t)cs * 16 * 32 + i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;
  auto av = [&](int r, int k) { return (uint32_t)a[r * 16 + k]; };
  const uint32_t af[4] = {av(r0, 2 * t) | av(r0, 2 * t + 1) << 16, av(r0 + 8, 2 * t) | av(r0 + 8, 2 * t + 1) << 16,
                          av(r0, 2 * t + 8) | av(r0, 2 * t + 9) << 16,
                          av(r0 + 8, 2 * t + 8) | av(r0 + 8, 2 * t + 9) << 16};
  float d[16];
  for (int i = 0; i < 16; ++i)
    d[i] = C[(size_t)cs * 64 * 32 + (r0 + 8 * ((i >> 1) & 1)) * 32 + 8 * (i >> 2) + 2 * t + (i & 1)];
  fence_regs(d);
  wgmma_fence();
  wgmma_n32(d, af, kmajor_desc(bs, 128, 256), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  for (int i = 0; i < 16; ++i)
    D[(size_t)cs * 64 * 32 + (r0 + 8 * ((i >> 1) & 1)) * 32 + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
}
extern "C" int run_probe(const void* A, const void* B, const float* C, float* D, int cases) {
  probe<<<cases, 128>>>((const uint16_t*)A, (const uint16_t*)B, C, D);
  return (int)cudaDeviceSynchronize();
}
"""

CROP_H, CROP_W = 512, 768


def _rz32(s: np.ndarray) -> np.ndarray:
    """f64 values rounded toward zero to f32."""
    f = s.astype(np.float32).astype(np.float64)
    over = np.abs(f) > np.abs(s)
    f[over] = np.nextafter(f[over].astype(np.float32), np.float32(0)).astype(np.float64)
    return f


def _exponent(v: np.ndarray) -> np.ndarray:
    return np.where(v != 0, np.floor(np.log2(np.where(v != 0, np.abs(v), 1.0))), -1e4)


def wgmma_rounding(dev) -> dict:
    """Part 1: the probe's sums against the chop-and-truncate model."""
    from hybridquantization_tpu_torch.ops import _cuda

    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hybridquantization_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
        with open(src, "w") as fh:
            fh.write(PROBE)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, src, "-o", lib],
                       check=True, capture_output=True)
        run = ctypes.CDLL(lib).run_probe
        rng = np.random.default_rng(0)
        cases = 96
        A, B, C = np.zeros((cases, 64, 16)), np.zeros((cases, 16, 32)), np.zeros((cases, 64, 32))
        for i in range(cases):
            spread, mode = (2, 8, 16, 30)[i // 24], i % 4
            a = rng.standard_normal((64, 16)) * 2.0 ** rng.integers(-spread, 1, (64, 16))
            b = rng.standard_normal((16, 32)) * 2.0 ** rng.integers(-spread, 1, (16, 32))
            if mode in (1, 3):
                a, b = np.abs(a), np.abs(b)
            if mode >= 2:
                C[i] = rng.standard_normal((64, 32)) * 2.0 ** rng.integers(-4, 4, (64, 32))
                C[i] = np.abs(C[i]) if mode == 3 else C[i]
            A[i], B[i] = a, b
        Ab = torch.from_numpy(A.astype(np.float32)).to(torch.bfloat16)
        Bb = torch.from_numpy(B.astype(np.float32)).to(torch.bfloat16)
        Ct = torch.from_numpy(C.astype(np.float32)).to(dev)
        At, Bt, D = Ab.view(torch.int16).to(dev), Bb.view(torch.int16).to(dev), torch.empty_like(Ct)
        rc = run(ctypes.c_void_p(At.data_ptr()), ctypes.c_void_p(Bt.data_ptr()), ctypes.c_void_p(Ct.data_ptr()),
                 ctypes.c_void_p(D.data_ptr()), cases)
        if rc != 0:
            raise RuntimeError(f"wgmma probe: CUDA error {rc}")
    A, B, D = Ab.double().numpy(), Bb.double().numpy(), D.cpu().double().numpy()
    C = Ct.cpu().double().numpy()
    prods = np.moveaxis(A[:, :, :, None] * B[:, None, :, :], 2, -1)  # (cases, 64, 32, 16)
    e = np.moveaxis(_exponent(A)[:, :, :, None] + _exponent(B)[:, None, :, :], 2, -1)
    e = np.where(prods != 0, e, -1e4)
    emax = np.maximum(e.max(-1), _exponent(C))
    grid = 2.0 ** np.maximum(emax - 25, -1000)
    model = _rz32((np.trunc(prods / grid[..., None]) * grid[..., None]).sum(-1) + np.trunc(C / grid) * grid)
    exact = C + prods.sum(-1)
    return {"sums": int(D.size), "model_match": float(np.mean(model == D)),
            "round_to_nearest_match": float(np.mean(exact.astype(np.float32) == D)),
            "round_toward_zero_match": float(np.mean(_rz32(exact) == D))}


def _passes(q, kh, kv, order: str):
    """The (pop, 7, H, W) filter outputs of the split's products summed in
    `order` ("exact" or "tpu"), each pass mirrored at its borders."""
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.ops.conv import mirror_index
    from hybridquantization_tpu_torch.scielab.transform import SRC7

    def conv(x, k, axis):
        taps = k.shape[1]
        x = x.index_select(axis, mirror_index(x.shape[axis], taps // 2, x.device))
        (xh, xl), (th, tl) = ff.split_bf16(x), ff.split_bf16(k.view(7, taps, 1, 1))
        n = x.shape[axis] - taps + 1
        if order == "exact":
            out = torch.zeros_like(xh.narrow(axis, 0, n), dtype=torch.float64)
            for t in range(taps):
                h = xh.narrow(axis, t, n).double()
                out += th[:, t].double() * h + th[:, t].double() * xl.narrow(axis, t, n).double() + tl[:, t].double() * h
            return out.float()
        dots = []
        for a, b in ((th, xh), (th, xl), (tl, xh)):
            acc = torch.zeros_like(xh.narrow(axis, 0, n))
            for t in range(taps):
                acc += a[:, t] * b.narrow(axis, t, n)
            dots.append(acc)
        return (dots[0] + dots[1]) + dots[2]

    return conv(conv(q[:, list(SRC7)], kh, -1), kv, -2)


def _sums(y, target, wp):
    from hybridquantization_tpu_torch import colorspace as cs

    filtered = y[:, 0:3] + y[:, 3:6]
    filtered[:, 0] += y[:, 6]
    lab = cs.opp_to_lab(torch.movedim(filtered, -3, -1), wp)
    return cs.DELTA_E_FNS["CIE76"](torch.movedim(target, 0, -1), lab).sum(dim=(1, 2))


def orders(dev) -> dict:
    """Part 2: each member's Delta-E sum of the kernel, exact and tpu
    against the plain split, on the frame and its crops."""
    import chip_smoke as smoke
    from hybridquantization_tpu_torch import QuantizationConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.synth import natural_image

    H, W, pop = smoke.H, smoke.W, smoke.POP
    img = natural_image(H, W, seed=0)
    pals = torch.rand((pop, smoke.K, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    feats = torch.as_tensor(img, device=dev).reshape(-1, 3).contiguous()
    opp = ak.assign_opp_usage_pop(feats, pals, cs.srgb_to_opp(pals).contiguous())[0].reshape(pop, 3, H, W)
    ctx = _make_context(img, build_filters(), QuantizationConfig(), dev)
    kh, kv, wp = ctx["kh"], ctx["kv"], ctx["whitepoint"]
    regions = {"frame": (slice(None), slice(None))}
    for r in range(0, H - CROP_H + 1, CROP_H):
        for c in range(0, W - CROP_W + 1, CROP_W):
            regions[f"{r}:{r + CROP_H},{c}:{c + CROP_W}"] = (slice(r, r + CROP_H), slice(c, c + CROP_W))

    def rel(x, w):
        return ((x.double() - w.double()) / w.double()).tolist()

    rows = {}
    for name, (rs, cs_) in regions.items():
        q, t = opp[..., rs, cs_].contiguous(), ctx["target_planar"][..., rs, cs_].contiguous()
        args = (q, t, kh, kv, wp, "CIE76")
        kernel = ff.fused_scielab_err_sums(*args, precision="split")
        plain = ff.fused_scielab_err_sums_reference(*args, precision="split")
        exact, tpu = (_sums(_passes(q, kh, kv, o), t, wp) for o in ("exact", "tpu"))
        rows[name] = {"kernel": rel(kernel, plain), "exact": rel(exact, plain), "tpu": rel(tpu, plain),
                      "kernel_vs_exact": rel(kernel, exact)}
        print(name, {k: [f"{v:.3g}" for v in vs] for k, vs in rows[name].items()}, flush=True)
    crops = [r for n, r in rows.items() if n != "frame"]

    def over(key):
        return sum(abs(v) > smoke.B2_SPLIT_RTOL for r in crops for v in r[key])

    worst = {k: max(abs(v) for r in crops for v in r[k]) for k in ("kernel", "exact", "tpu", "kernel_vs_exact")}
    return {"limit": smoke.B2_SPLIT_RTOL, "pairs": len(crops) * pop,
            "over_limit": {k: over(k) for k in ("kernel", "exact", "tpu", "kernel_vs_exact")},
            "worst": worst, "regions": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    ap.add_argument("--root", default="", help="the checkout whose package runs part 2 (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_band: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.abspath(args.root)] if args.root else []
    sys.path.insert(1 if args.root else 0, here)
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.ops import fused_fitness

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = setup_device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "package": os.path.dirname(os.path.dirname(fused_fitness.__file__)),
           "wgmma": wgmma_rounding(dev), "orders": orders(dev)}
    print("wgmma", out["wgmma"])
    print("orders: over the limit", out["orders"]["over_limit"], "of", out["orders"]["pairs"],
          "worst", {k: f"{v:.3g}" for k, v in out["orders"]["worst"].items()})
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
