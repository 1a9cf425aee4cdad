"""plan_roofline.<mix>: device planning's share of its roofline, in %:
the least time that the window's planning work needs on the card
(rooflines/plan.py) over the profiler's device time of K4's gathered
entry and K3's reference entry in the window.  Nothing is read when no
planning kernel ran."""

from benchmark import spec


def read(ctx):
    rl = spec.roofline("plan")
    dev = ctx.timeline.device_seconds(rl.is_kernel)
    if dev <= 0 or not ctx.plan_work:
        return None
    return 100.0 * rl.least_seconds(ctx.plan_work, spec.peaks())[0] / dev
