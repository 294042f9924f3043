"""The share of the training window in which nothing ran on the device:
1 - the union of the device operations' intervals over the profiled
stretch of ``K`` steps after the window (one slot step among them in
``train_adcc``), from the profiler's trace."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or tr.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
