"""A guard for torch's CPU transcendental functions on their first call.

With MKL, torch's CPU `sqrt`, `log` (and `pow(x, 0.5)`, which torch routes to
`sqrt`) and their kin run MKL's vector math library in chunks of 2048
elements, one chunk per intra-op thread. When the first such call of a
process runs on two or more threads at once, a thread's chunk can come out
up to ~3e-4 relative off (2-10% of fresh processes at 2 or 8 threads, the
whole chunk of one thread or two, `tools/cpu_math_check.py`); the same
call again is exact.
A first call that runs on one thread (a tensor below one chunk) leaves
every later call exact, at any thread count, so the package makes that call
for each such function once, when this module is imported (the package's
`__init__` imports it first, before any CPU path of it can run):
`warm_up()` below.
"""

from __future__ import annotations

import torch

# the vector-math functions of the port's CPU paths (colorspace: sqrt, sin,
# cos, exp, atan2 and pow at 2.4, 1 / 2.4 and 1 / 3; swasa.schedule: exp and
# tanh; ops.kmeans: log; ops.assign: sqrt). The fault was reproduced for
# sqrt, log and pow(x, 0.5); the others are warmed alike.
_UNARY = (torch.sqrt, torch.log, torch.exp, torch.tanh, torch.sin, torch.cos)
_EXPONENTS = (0.5, 2.4, 1.0 / 2.4, 1.0 / 3.0)


def warm_up() -> None:
    """Make the first call of each of those functions on one thread (a
    one-element tensor, below the 2048-element parallel chunk), in float32
    and float64. Calling it again is harmless."""
    for dtype in (torch.float32, torch.float64):
        x = torch.full((1,), 0.5, dtype=dtype)
        for fn in _UNARY:
            fn(x)
        torch.atan2(x, x)
        for e in _EXPONENTS:
            torch.pow(x, e)


warm_up()
