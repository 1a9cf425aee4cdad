"""filters_cpu_ms_per_frame.<mix>: the thread CPU time of the port's PROF
`stage.deblock`, `stage.sao` and `stage.alf` spans (the in-loop filters'
derivation and application, CC-ALF's too) under the pictures whose
`pic.encode` span ended in the traced window, in milliseconds a picture.
Nothing is read when no such span is there."""

from benchmark import spans


def read(ctx):
    return spans.cpu_ms_per_picture(
        ctx, {"stage.deblock", "stage.sao", "stage.alf"})
