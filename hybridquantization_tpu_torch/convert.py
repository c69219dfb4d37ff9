"""Carry state and operands from the JAX package into this one.

Both take plain numpy arrays, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .scielab.filters import ScielabFilters
from .swasa.state import SWASAState

_TENSORS = ("colors", "current_errors", "best_colors", "best_error", "temperature")


def state_from_jax_numpy(d: dict, device="cpu") -> SWASAState:
    """The port's state from `hybridquantization_tpu.swasa.state.state_to_numpy`.

    The tensors carry over as they are. The JAX key's data (two uint32 words)
    seeds the port's generator: a `torch.Generator` cannot reproduce a
    `jax.random` stream, so from here on the two runs draw different numbers
    unless the caller feeds both the same draws (swasa.loop.make_step).
    """
    device = torch.device(device)
    key = np.asarray(d["key"], np.uint32).reshape(-1)
    seed = 0
    for word in key:
        seed = (seed << 32) | int(word)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed % (1 << 64))
    return SWASAState(
        **{k: torch.tensor(np.asarray(d[k], np.float32), device=device) for k in _TENSORS},
        iteration=torch.tensor(np.asarray(d["iteration"], np.int32), device=device),
        generator=generator,
    )


_NEG = -1e30  # the bias of JAX's padded palette entries (pallas_assign.py:76, :133)


def probe_operands_from_jax_numpy(x4, c4, o4=None, n=None, *, block=None):
    """The port's probe operands (`ops.probe_kernels`) from a JAX probe's.

    Args:
      x4: packed pixels, (4, P_pad), or T1's (4, nb, 8, L) (`run_vpu`).
      c4: candidates: (pop, 4, K_pad); T1's (pop * 4, K_pad); T2's transposed
        (pop, K_pad, 4); or the minidot probe's per-run sets (pop, runs per
        block, 4, KC), which every grid block of `block` pixels reuses.
      o4: the colours, laid out as c4, or None.
      n: the true pixel count; pixels at or past it are dropped.
      block: the JAX grid's pixels per block (per-run sets only).

    Returns:
      (x (4, P), c, o) f32 CPU tensors: c and o (pop, 4, K) with the
      trailing entries whose bias is -1e30 in every member dropped, or (pop,
      ceil(P / run), 4, KC) with each block's sets repeated over the blocks.
      Row 3 of x is kept as it is (ones for a packed image; the minidot probe
      draws it at random).
    """
    x = np.asarray(x4, np.float32)
    x = x.reshape(x.shape[0], -1)
    if n is not None:
        x = x[:, : int(n)]
    P = x.shape[1]

    def layout(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 2:
            return a.reshape(-1, 4, a.shape[-1])
        if a.ndim == 3 and a.shape[1] != 4:
            return a.transpose(0, 2, 1)
        if a.ndim == 4:
            if block is None:
                raise ValueError("per-run candidate sets need the JAX grid's block")
            runs = a.shape[1]
            run = block // runs
            return a[:, np.arange(-(-P // run)) % runs]
        return a

    c = layout(c4)
    o = None if o4 is None else layout(o4)
    if c.ndim == 3:
        pad = np.all(c[:, 3, :] == _NEG, axis=0)
        K = c.shape[-1]
        while K > 0 and pad[K - 1]:
            K -= 1
        c = c[..., :K]
        o = None if o is None else o[..., :K]

    def tensor(a):
        return None if a is None else torch.tensor(np.ascontiguousarray(a))

    return tensor(x), tensor(c), tensor(o)


def filters_from_numpy(k1, k2, k3, k3_abs, samp_per_deg) -> ScielabFilters:
    """A filter bank from another package's arrays (e.g. the fields of
    `hybridquantization_tpu.scielab.filters.ScielabFilters`), so both packages
    filter with the same taps."""
    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return ScielabFilters(
        k1=f32(k1), k2=f32(k2), k3=f32(k3), k3_abs=f32(k3_abs), samp_per_deg=int(samp_per_deg)
    )
