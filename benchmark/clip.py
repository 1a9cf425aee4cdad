"""The benchmark's seeded test clips: 8-bit 4:2:0 pictures made from a seed.

Written from vvenc_tpu_torch.tools.calibrate_plan.make_clip, the smooth
pan of the repository's bench.py (gaussian-filtered noise, a window
moving 2 samples right and 1 down a picture), with three changes: the
noise comes from the run's seed, it is scaled to a fixed contrast, and
textured regions with sharp edges move across the picture against the
pan.  A smooth pan alone
lets the QT search stop at 64x64 and the ME settle on one vector; the
regions give the search deep splits, residual and motion of their own.

Region r always has side region_sizes[r], grating period
grating_periods[r mod len] and grating angle r * 180 / n degrees.  The
content seed lays the regions out (which cell of a grid each starts in,
its offset in the cell) and draws the phases, the noise and the
direction of the common motion.  The regions move together, so they
never overlap, and the textured area is the same in every picture.

With `content_seed` among the parameters, the pictures are drawn from it
and the run's seed only shuffles their order: every seed codes the same
set of pictures, which is the same work where pictures are coded alone
(all-intra).  Without it the run's seed draws the content, in display
order, for a cell whose pictures predict from each other.
"""

from __future__ import annotations

import numpy as np

DEFAULTS = {
    "blur_sigma": 3.0,       # the pan's noise filter (make_clip's)
    "region_sizes": [32, 40, 48, 56, 64, 72],    # sides, one per region
    "region_speed": 3.0,     # samples a picture, against the pan
    "grating_periods": [4.0, 7.0, 12.0],         # samples, cycled
    "grating_amplitude": 40.0,
    "noise_amplitude": 4.0,   # white noise inside a region
    "content_seed": None,     # the pictures' own seed; the run's shuffles
}


def params(cfg_clip: dict | None) -> dict:
    out = dict(DEFAULTS)
    out.update(cfg_clip or {})
    return out


def make_clip(seed: int, w: int, h: int, frames: int,
              clip_params: dict | None = None):
    """`frames` pictures (Y, U, V) of uint8 planes, h x w and h/2 x w/2,
    the same for the same seed and parameters."""
    p = params(clip_params)
    if p["content_seed"] is None:
        return _pictures(seed, w, h, frames, p)
    pics = _pictures(p["content_seed"], w, h, frames, p)
    order = _rng(seed).permutation(frames)
    return [pics[i] for i in order]


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(int(seed) & ((1 << 63) - 1)))


def _pictures(seed: int, w: int, h: int, frames: int, p: dict):
    import scipy.ndimage as ndi
    rng = _rng(seed)
    base = ndi.gaussian_filter(
        rng.integers(0, 255, (h + 4 * frames, w + 4 * frames))
        .astype(np.float32), p["blur_sigma"])
    # make_clip stretches the noise to 20..220; scaling it to a fixed
    # standard deviation instead keeps the pan's contrast from seed to
    # seed
    base = (base - base.mean()) / base.std() * 25.0 + 120.0

    sizes = [int(x) for x in p["region_sizes"]]
    n = len(sizes)
    periods = p["grating_periods"]
    # a grid of cells, one region starting in each, in an order drawn
    # from the seed; the pan moves the content left and up, the regions
    # move right and down together, at an angle within +-45 degrees of
    # that diagonal
    cols = int(np.ceil(np.sqrt(n * w / h)))
    rows = int(np.ceil(n / cols))
    cw, ch = w // cols, h // rows
    if max(sizes) > min(cw, ch):
        raise ValueError(f"regions of {max(sizes)} do not fit cells of "
                         f"{cw}x{ch}")
    cell = rng.permutation(cols * rows)[:n]
    pos0 = np.array([[(c % cols) * cw + rng.integers(0, cw - sz + 1),
                      (c // cols) * ch + rng.integers(0, ch - sz + 1)]
                     for c, sz in zip(cell, sizes)], np.float64)
    ang = np.pi / 4 + rng.uniform(-np.pi / 4, np.pi / 4)
    vel = np.array([np.cos(ang), np.sin(ang)]) * p["region_speed"]
    phase = rng.uniform(0, 2 * np.pi, n)
    textures = []
    for r, sz in enumerate(sizes):
        yy, xx = np.mgrid[0:sz, 0:sz].astype(np.float64)
        th = np.pi * r / n
        g = np.sin(2 * np.pi * (xx * np.cos(th) + yy * np.sin(th))
                   / periods[r % len(periods)] + phase[r]) \
            * p["grating_amplitude"]
        g += rng.uniform(-1, 1, (sz, sz)) * p["noise_amplitude"]
        textures.append(g)
    tint = [(30 * np.cos(2 * np.pi * r / n), 30 * np.sin(2 * np.pi * r / n))
            for r in range(n)]

    out = []
    for i in range(frames):
        y = base[i:i + h, 2 * i:2 * i + w].copy()
        u = y[::2, ::2] / 2 + 60
        v = 128 - y[::2, ::2] / 3
        for r in range(n):
            s = textures[r].shape[0]
            x0, y0 = np.floor(pos0[r] + vel * i).astype(int)
            # regions wrap around the picture so that each stays on it
            ys = (y0 + np.arange(s)) % h
            xs = (x0 + np.arange(s)) % w
            y[np.ix_(ys, xs)] = 128 + textures[r]
            cy = np.unique(ys // 2)
            cx = np.unique(xs // 2)
            u[np.ix_(cy, cx)] = 128 + tint[r][0]
            v[np.ix_(cy, cx)] = 128 + tint[r][1]
        out.append(tuple(np.clip(np.rint(pl), 0, 255).astype(np.uint8)
                         for pl in (y, u, v)))
    return out


def write_yuv(path: str, pictures) -> None:
    with open(path, "wb") as f:
        for pic in pictures:
            for pl in pic:
                f.write(np.ascontiguousarray(pl).tobytes())
