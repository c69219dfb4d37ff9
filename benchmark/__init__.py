"""The benchmark of `hybridquantization_tpu_torch` on NVIDIA H100s.

`run.py` runs one cell of `BENCHMARK.json` once; `readings.py` reads the
numbers the limits of `limits/` are set from. Nothing here imports JAX
or the JAX package, and `reference/` imports nothing of the program.
"""
