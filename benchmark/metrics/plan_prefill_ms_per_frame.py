"""plan_prefill_ms_per_frame: the port's PROF span `device.plan_prefill`,
the frame-batched planning of the CLI's all-intra encode
(sequence._prefill_plans), which the frame-parallel pool waits for, in
milliseconds a picture coded in the traced window. PROF sums over
threads, so with frame-parallel pictures this is CPU-milliseconds a
picture. Nothing is read when the span did not open."""


def read(ctx):
    return ctx.span_ms_per_frame("device.plan_prefill")
