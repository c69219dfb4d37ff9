"""Checkpoint/resume for long annealing runs.

The counterpart of `hybridquantization_tpu/checkpoint.py`, in the port's
own state: the tensors of swasa.state.SWASAState and the generator's state
bytes with its device type, in place of the JAX key. The reference has no
checkpointing (SURVEY.md section 5); the state is small, so a plain .npz
round trip is exact. `load_state` also reads a checkpoint the JAX package
wrote (it has `key` and no `generator`) through convert.state_from_jax_numpy,
which seeds a generator from the key: the run carries over, its later draws
are the port's own.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from .convert import state_from_jax_numpy
from .swasa.state import SWASAState, state_from_numpy, state_to_numpy

_FORMAT_VERSION = 1


def save_state(path: str, state: SWASAState, extra: dict | None = None) -> None:
    """Atomically write the annealing state (+ optional metadata) to .npz:
    into a temporary file beside `path`, renamed over it when complete and
    removed if the write fails."""
    payload = state_to_numpy(state)
    payload["__version__"] = np.int32(_FORMAT_VERSION)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, device=None) -> tuple[SWASAState, dict]:
    """Load (state, extra-metadata dict).

    device: where the state's tensors go. A checkpoint of this package
    restores its generator only on the device type it was saved from, which
    is also the default (swasa.state.state_from_numpy); a JAX checkpoint
    defaults to the CPU.
    """
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    version = int(data.pop("__version__", 1))
    if version > _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} is newer than supported")
    extra = {k[6:]: data.pop(k) for k in list(data) if k.startswith("extra_")}
    if "generator" not in data and "key" in data:
        return state_from_jax_numpy(data, "cpu" if device is None else device), extra
    return state_from_numpy(data, device), extra
