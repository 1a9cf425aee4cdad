"""Tiny sizes of the cell for CPU rehearsals of the harness: the same
control flow and comparisons as a measured run, on the kernels' plain
versions (device="cpu"), with no metric taken for a device's.

"ai" is the cell's all-intra configuration cut to 128x64; "ra" runs the
same cell as a random-access encode (an IDR, then a GOP of 8, device ME
on its plain version), which rehearses the file entry's judging of a
stream whose pictures predict from each other (decoded in order)."""

import time

from benchmark import spec
from benchmark.harness import Run, run_cell

CELL = "ai_faster_d416.file"
CLIP = {"region_sizes": [8, 12, 16, 20, 24, 28]}
OVERRIDES = {
    "ai": dict(width=128, height=64, clip_frames=4, warm_frames=1,
               set={"device_rd": "on"},
               clip=dict(CLIP, content_seed=20261018)),
    "ra": dict(width=128, height=64, clip_frames=9, warm_frames=3,
               intra_period=0, gop_size=8, set={"me_mode": "device"},
               clip=CLIP),
}
LIMITS = {"ra": {"stream_differs": 0, "recon_mismatch": 0}}


def tiny_run(kind="ai", seed=987654321012, seconds=1.5, trace=False,
             cfg=None, **kw):
    over = dict(OVERRIDES[kind])
    over.update(cfg or {})
    kw.setdefault("limits", LIMITS.get(kind))
    run = Run(spec.load_benchmark(), CELL, seed, seconds, trace,
              device="cpu", cfg_override=over, **kw)
    return run, run_cell(run, time.time())
