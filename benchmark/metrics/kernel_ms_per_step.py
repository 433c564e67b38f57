"""Device milliseconds of the kernels a step, summed over every kernel of
the traced window (overlapping kernels each counted), over its steps."""


def read(run):
    trace = run["trace"]
    kernels = trace.kernels()
    if not kernels:
        return None
    return 1e3 * sum(e - s for _, s, e in kernels) / run["steps"]
