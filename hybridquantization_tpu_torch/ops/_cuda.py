"""Build and bind the package's CUDA kernels.

`csrc/*.cu` compile with nvcc (one process per source, in parallel) and
link into one shared library with a plain C interface, loaded with ctypes. The build runs at the first launch on a CUDA
tensor (never at import: the CPU tests import every module), into
`hybridquantization_tpu_torch/_build/`, under a name that hashes the sources
and flags, so an edited source is rebuilt and an unchanged one is reused
within a checkout. Every exported function returns the `cudaGetLastError()`
of its launches; `check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # feats, pal, opp_pal, B, P, K, pop, bf16, average, packed, opp_out, counts,
    # idx_out, stream
    "hq_assign_pop": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # q, left, right, target, bands, vmap, vtables, taps, members, pop, H, W, wp0, wp1, wp2,
    # kind, rows_per_block, smem_bytes, n_partials, partials, sums, stream
    "hq_band_err_sums": [_P, _P, _P, _P, _P, _P, *[_I] * 6, _F, _F, _F, *[_I] * 4, _P, _P, _P],
    # feats, pal, F, M, P, K, idx_out, stream
    "hq_assign_idx": [_P, _P, _I, _I, _I, _I, _P, _P],
    # feats, weights, pal, F, M, P, K, blocks, tiles_per_block, partials, out, stream
    "hq_lloyd_step": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # q, left, right, target, kh, kv, host_taps, taps, members, pop, H, W, wp0,
    # wp1, wp2, kind, bf16, rows_per_block, smem_bytes, n_partials, t7, partials,
    # sums, stream
    "hq_fused_err_sums": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _P, _P,
        _P, _P,
    ],
    # x, c4, o4, P, K, pop, slots, width, unroll, threads, blocks, tile, tile_f4, staged,
    # resident, shared_hist, smem, opp, counts, stream
    "hq_probe_kloop": [_P, _P, _P, *[_I] * 14, _P, _P, _P],
    # x4, c, P, Kc, pop, run, out_bf16, nb, wgs, blocks, smem, out, stream
    "hq_split_rowmax": [_P, _P, *[_I] * 9, _P, _P],
    # x4, c, o, P, Kc, pop, run, average, opp_parts, nb, wgs, blocks, shared_hist, smem, opp,
    # counts, idx, stream
    "hq_split_assign": [_P, _P, _P, *[_I] * 11, _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
#: seconds and nvcc output of the build this process did (None if reused)
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhq_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise on a failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> Path:
    """Compile csrc/*.cu into the build directory (if not already there):
    one nvcc per source, all started together, then one link."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        t0 = time.perf_counter()
        objs = [tmp / f"{src.stem}.o" for src in _sources()]
        log = _run_all([
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(src)]
            for src, o in zip(_sources(), objs)
        ])
        lib = tmp / "lib.so"
        log += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
