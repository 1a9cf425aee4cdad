"""pool_wait_share.<mix>: the share of a picture's wall time that its
thread spent off the CPU (waiting for the GIL or a lock, or not
scheduled), 100 x (1 - thread CPU / wall) summed over the port's PROF
`pic.encode` spans that ended in the traced window, in %.  Nothing is
read when no picture span ended there."""

from benchmark import spans


def read(ctx):
    got = spans.window_pictures(ctx)
    if got is None:
        return None
    pics = got[0]
    wall = sum(p.end_ns - p.start_ns for p in pics)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(p.cpu_ns for p in pics) / wall)
