"""Share of the traced window in which nothing ran on the device: one
minus the union of the device's kernel, copy and set intervals over the
window."""


def read(run):
    trace = run["trace"]
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
