"""The port's PROF records of the pictures coded in the traced window,
for the per-layer readers of metrics/ that read thread CPU time.

PROF (vvenc_tpu_torch.utils.profiler, on in the traced run) records one
span per stage: its name, id and parent, the picture (`pic.encode`
spans, one per picture coded), start and end on time.time_ns() (the
clock of torch.profiler's events, so the window's bounds apply as they
are) and the thread's CPU time.  A port whose PROF keeps no records
gives nothing here, and its readers report nothing.
"""

from __future__ import annotations

PICTURE = "pic.encode"


def window_pictures(ctx):
    """(pictures, records): the `pic.encode` records that ended inside
    the traced window, and every record PROF kept; None when no picture
    span ended there."""
    tl = ctx.timeline
    if tl is None:
        return None
    from vvenc_tpu_torch.utils import profiler
    get = getattr(profiler.PROF, "records", None)
    if get is None:
        return None
    recs = get()
    lo, hi = tl.window
    pics = [r for r in recs
            if r.name == PICTURE and lo <= r.end_ns * 1e-9 <= hi]
    return (pics, recs) if pics else None


def cpu_ms_per_picture(ctx, names):
    """Thread CPU milliseconds of the records named in `names` that lie
    under a picture of the window (its span is among their parents),
    over the count of those pictures; None when no such record is
    there."""
    got = window_pictures(ctx)
    if got is None:
        return None
    pics, recs = got
    ids = {p.id for p in pics}
    parent = {r.id: r.parent for r in recs}
    cpu_ns, n = 0, 0
    for r in recs:
        if r.name not in names:
            continue
        p = r.parent
        while p is not None and p not in ids:
            p = parent.get(p)
        if p is not None:
            cpu_ns += r.cpu_ns
            n += 1
    return cpu_ns * 1e-6 / len(pics) if n else None
