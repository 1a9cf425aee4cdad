"""Records what the port's device planning produces on the timed path.

The probes wrap two functions of the port where its encoder looks them
up at call time (module attributes), so the timed path calls them with
no change to the program:

  ops.intra_plan.build_plans       a planning batch of host pictures
  ops.intra_plan._plan_batch_core  its device work (K4 gathered -> K3
                                   refs per QT class)

Every batch is counted (pictures planned, calls, the blocks of each
class for the rooflines).  While `keep` is set, a batch that holds one
of the `targets` (the judged pictures, drawn from the seed before the
window) keeps, for that picture only, a device copy of its plane and
references to the batch's outputs and λ, for the comparison once the
window has closed.  Finding the picture is a comparison of host arrays;
the copy is one device-to-device copy of a plane, about 0.5 MB at
416x240; nothing is waited for inside the window.
"""

from __future__ import annotations

import threading

import numpy as np


class Probes:
    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.keep = False
        self.targets = []        # [(picture index, int32 luma at depth)]
        self.plans = []          # one dict a kept picture
        self.kept_bytes = 0      # device bytes the kept planes hold
        self.plan_pictures = 0   # pictures planned, all calls
        self.plan_calls = 0
        # blocks planned by (class side, k, bit depth), for the rooflines
        self.plan_work = {}
        self._undo = []

    def _hits(self, srcs):
        """[(position in the batch, picture index)] of the targets."""
        out = []
        for f, s in enumerate(srcs):
            for idx, t in self.targets:
                if s.shape == t.shape and np.array_equal(s, t):
                    out.append((f, idx))
                    break
        return out

    def install(self) -> "Probes":
        from vvenc_tpu_torch.ops import intra_plan
        build_orig = intra_plan.build_plans
        core_orig = intra_plan._plan_batch_core

        def build_plans(srcs, *args, **kw):
            self._local.hits = self._hits(srcs) if self.keep else []
            try:
                return build_orig(srcs, *args, **kw)
            finally:
                self._local.hits = []

        def plan_batch_core(*args, **kw):
            out = core_orig(*args, **kw)
            planes, lmbda, lmbda_sad, sizes, W, H, qp, bit_depth, \
                implicit_mts, k = args[:10]
            F = int(planes.shape[0])
            hits = getattr(self._local, "hits", None) or []
            with self._lock:
                self.plan_calls += 1
                self.plan_pictures += F
                for s in sizes:
                    key = (int(s), int(k), int(bit_depth))
                    self.plan_work[key] = self.plan_work.get(key, 0) + \
                        F * (W // s) * (H // s)
                for f, idx in hits:
                    plane = planes[f].clone()
                    self.kept_bytes += plane.numel() * plane.element_size()
                    self.plans.append({
                        "picture": idx, "f": f, "F": F, "plane": plane,
                        "lmbda": lmbda, "lmbda_sad": lmbda_sad,
                        "sizes": tuple(sizes), "W": W, "H": H, "qp": qp,
                        "bit_depth": bit_depth,
                        "implicit_mts": implicit_mts, "k": k,
                        "modes": out[0], "costs": out[1]})
            return out

        intra_plan.build_plans = build_plans
        intra_plan._plan_batch_core = plan_batch_core
        self._undo = [(intra_plan, "build_plans", build_orig),
                      (intra_plan, "_plan_batch_core", core_orig)]
        return self

    def uninstall(self) -> None:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []

    def counts(self) -> dict:
        with self._lock:
            return {"plan_pictures": self.plan_pictures,
                    "plan_calls": self.plan_calls,
                    "kept_device_bytes": self.kept_bytes}
