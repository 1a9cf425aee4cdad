"""host_cpu_ms_per_frame.<mix>: the thread CPU time of coding a picture,
from the port's PROF `pic.encode` spans that ended in the traced window,
in milliseconds a picture.  Nothing is read when no picture span ended
there."""

from benchmark import spans


def read(ctx):
    got = spans.window_pictures(ctx)
    if got is None:
        return None
    pics = got[0]
    return sum(p.cpu_ns for p in pics) * 1e-6 / len(pics)
