"""device_idle_share.<mix>: the share of the traced window in which the
card ran nothing, 1 - (union of kernel, copy and set intervals on the
device) / window, in %, from torch.profiler's device trace."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
