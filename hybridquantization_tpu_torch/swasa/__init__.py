"""SWASA annealing: schedule math, state, and the device loop."""

from . import schedule
from .loop import init_state, make_step, run_chunk
from .state import SWASAState, state_from_numpy, state_to_numpy

__all__ = [
    "SWASAState",
    "init_state",
    "make_step",
    "run_chunk",
    "schedule",
    "state_from_numpy",
    "state_to_numpy",
]
