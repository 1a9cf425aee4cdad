"""ctu_search_ms_per_frame: the port's PROF span `slice.ctu_search`, the
host CTU search (native vte_search_ctu), in milliseconds a picture coded
in the traced window. PROF sums over threads, so with frame-parallel
pictures this is CPU-milliseconds a picture. Nothing is read when the
span did not open."""


def read(ctx):
    return ctx.span_ms_per_frame("slice.ctu_search")
