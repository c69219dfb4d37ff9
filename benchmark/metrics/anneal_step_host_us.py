"""anneal_step_host_us: the mean host duration of the program's
`hq.anneal.step` spans (`swasa/loop.run_chunk`): one iteration's Python
and launch calls, under the profiler, in microseconds."""

from benchmark.program import host_ms, spans


def read(data):
    n = len(spans(data, "hq.anneal.step"))
    return host_ms(data, "hq.anneal.step") * 1e3 / n if n else None
