"""The device: the share of the traced slice in which no kernel ran, from
the profiler's kernel intervals (`benchmark.trace`)."""


def read(run):
    if run.trace is None or not run.trace.window_s():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
