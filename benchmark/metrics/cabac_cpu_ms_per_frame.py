"""cabac_cpu_ms_per_frame.<mix>: the thread CPU time of the port's PROF
`slice.ctu_encode` spans (the CTUs' syntax through the arithmetic coder,
and its replay with the SAO / ALF syntax) under the pictures whose
`pic.encode` span ended in the traced window, in milliseconds a picture.
Nothing is read when no such span is there."""

from benchmark import spans


def read(ctx):
    return spans.cpu_ms_per_picture(ctx, {"slice.ctu_encode"})
