"""anneal_launches_per_iter: the kernel launch calls the profiler records
on the host (cudaLaunchKernel and its kin) inside the `find_palette`
spans, between the first and the last progress callback, over the
iterations between them: the anneal loop's launches, without the
context and seeding before it."""

from benchmark.layers import launches_per_iteration


def read(data):
    return launches_per_iteration(data, "find_palette")
