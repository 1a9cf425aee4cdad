"""The data flow of K8 mc_batch and K10's satd entry as the kernels on the
card run it (csrc/mc_batch.cu, csrc/dist_batch.cu), held in numpy against
the JAX reference (vvenc_tpu/ops/interp.py mc_batch, vvenc_tpu/ops/
rdcost.py satd_batch).  A CUDA kernel has no CPU mode, so these models are
what the CPU can check of the kernels' arithmetic and of the way they cut
the work; tests/test_torch_kernels.py holds the kernels themselves on the
card.

K8: a thread takes a run of R columns (4; 2 at chroma width 2) and a
segment of up to 8 output rows.  In the two-stage kind it filters each of
the segment's 8 + n - 1 window rows horizontally at its columns and slides
the last n results to emit each vertical output as soon as its n rows are
in; sums modulo 2^32, >> on the int32 value; a generic width reads 0 past
a row's end.  A thread block takes G consecutive windows, one task a
thread.

K10 satd: tiles 1..16 on T lanes (32 at 16), a lane a row of P = min(T, 8)
values; the row butterflies in the lane (and across the row's two lanes
at 16), the column butterflies across the tile's lanes (the lane whose bit
m is set takes the difference); tiles 32 and 64 go through shared memory
transposed between the passes; tiles 4 and 8 in elements of 32 tiles or
more take a thread a tile.  Every element's tiles are summed and stored
once.
"""

import jax
import numpy as np
import pytest

from vvenc_tpu.ops import interp as JI
from vvenc_tpu.ops import rdcost as JR
from vvenc_tpu_torch.ops import interp as IP

M32 = 0xFFFFFFFF
S = 8                     # K8's output rows a segment
LUMA_QUARTER = [(fx, fy) for fy in (0, 4, 8, 12) for fx in (0, 4, 8, 12)]


def _shift(acc, off, sh):
    """(int)(acc + off) >> sh on uint32 sums."""
    return (acc + np.uint32(off & M32)).view(np.int32) >> sh


def _fir(v, taps, n):
    """sum_k taps[k] * v[..., x + k] modulo 2^32 for every x."""
    L = v.shape[-1] - n + 1
    acc = np.zeros(v.shape[:-1] + (L,), np.uint32)
    for k in range(n):
        acc += np.uint32(taps[k] & M32) * v[..., k:k + L]
    return acc


def k8_model(win, fx, fy, w, h, bd, luma):
    """K8 on windows [B, h + n - 1, w + n - 1] int32, task by task."""
    n = 8 if luma else 4
    half = n // 2 - 1
    ntaps, kind, *rest = IP._k8_args(fx, fy, bd, luma)
    tx, ty = rest[:8], rest[8:16]
    sh1, off1, sh2, off2, maxval = rest[16:]
    R = 2 if (w == 2 and not luma) else 4
    B, WH, WW = win.shape
    ncol = -(-w // R)
    span = ncol * R + n - 1 + half
    up = np.zeros((B, WH, max(span, WW)), np.uint32)
    up[:, :, :WW] = win.view(np.uint32)       # 0 past the row's end
    out = np.zeros((B, h, ncol * R), np.int32)
    for y0 in range(0, h, S):
        if kind in (0, 1):
            for y in range(y0, min(y0 + S, h)):
                row = up[:, y + half]
                if kind == 0:
                    out[:, y] = row[:, half:half + ncol * R].view(np.int32)
                else:
                    out[:, y] = np.clip(_shift(_fir(
                        row[:, :ncol * R + n - 1], tx, n), off1, sh1),
                        0, maxval)
            continue
        hv = []
        for r in range(S + n - 1):
            row = y0 + r
            if row < WH:
                if kind == 2:
                    v = up[:, row, half:half + ncol * R].view(np.int32)
                else:
                    v = _shift(_fir(up[:, row, :ncol * R + n - 1], tx, n),
                               off1, sh1)
            else:
                v = np.zeros((B, ncol * R), np.int32)
            hv.append(v)
            y = row - (n - 1)
            if r >= n - 1 and y < h:
                acc = np.zeros((B, ncol * R), np.uint32)
                for k in range(n):
                    acc += np.uint32(ty[k] & M32) * \
                        hv[r - (n - 1) + k].view(np.uint32)
                out[:, y] = np.clip(_shift(acc, off2, sh2), 0, maxval)
    return out[:, :, :w]


SMEM_MAX, BAR_BYTES, SLACK_BYTES = 227 * 1024, 16, 32


def k8_plan(B, w, h, ntaps, kind=3, sms=132):
    """(G, tpw, ncol, R, threads, grid, bytes a window stages) of
    csrc/mc_batch.cu plan() for a window that fits shared memory: kinds 0
    and 1 stage rows half .. half + h of each window in a slot of its
    own, kinds 2 and 3 the whole windows."""
    R = 2 if (w == 2 and ntaps == 4) else 4
    ncol = -(-w // R)
    tpw = ncol * (-(-h // S))
    WW, WH = w + ntaps - 1, h + ntaps - 1
    wbytes = (h * WW * 4 + 15) // 16 * 16 + 16 if kind < 2 else WW * WH * 4
    G = max(1, min(24 * 1024 // wbytes, -(-256 // tpw), -(-B // (4 * sms))))
    tasks = G * tpw
    threads = 256 if tasks >= 256 else -(-tasks // 32) * 32
    return G, tpw, ncol, R, threads, -(-B // G), wbytes


def _jax_mc(win, fx, fy, w, h, bd, luma):
    return np.asarray(JI.mc_batch(win, fx, fy, w, h, bd, luma))


def _windows(rng, B, w, h, n, bd, wrap=False):
    shape = (B, h + n - 1, w + n - 1)
    if wrap:
        return rng.choice(np.array([-2 ** 31, 2 ** 31 - 1, -2 ** 30, 2 ** 30,
                                    -12345, 0, 1023], np.int64),
                          shape).astype(np.int32)
    win = rng.randint(0, 1 << bd, shape).astype(np.int32)
    win[0] = (1 << bd) - 1
    win[-1] = 0
    return win


# every luma phase on each axis (against 0 and against its mirror) and the
# 16 quarter-pel pairs chip_smoke.py times
LUMA_CASES = sorted(set([(f, 0) for f in range(16)] + [(0, f) for f in
                                                       range(16)]
                        + [(f, 15 - f) for f in range(16)] + LUMA_QUARTER))
CHROMA_CASES = [(fx, fy) for fy in (0, 1, 16, 31) for fx in (0, 1, 16, 31)] \
    + [(5, 27), (13, 2)]


@pytest.mark.parametrize("fx,fy", LUMA_CASES)
def test_k8_model_every_luma_phase_equals_the_reference(fx, fy):
    rng = np.random.RandomState(fx * 16 + fy)
    for (w, h), bd in (((16, 16), 10), ((8, 4), 8), ((12, 8), 12)):
        win = _windows(rng, 3, w, h, 8, bd)
        assert np.array_equal(k8_model(win, fx, fy, w, h, bd, True),
                              _jax_mc(win, fx, fy, w, h, bd, True)), (w, h)


@pytest.mark.parametrize("fx,fy", CHROMA_CASES)
def test_k8_model_chroma_phases_equal_the_reference(fx, fy):
    rng = np.random.RandomState(fx * 32 + fy)
    for (w, h), bd in (((8, 8), 10), ((2, 2), 8), ((6, 6), 10),
                       ((4, 8), 12)):
        win = _windows(rng, 3, w, h, 4, bd)
        assert np.array_equal(k8_model(win, fx, fy, w, h, bd, False),
                              _jax_mc(win, fx, fy, w, h, bd, False)), (w, h)


@pytest.mark.parametrize("luma", [True, False])
def test_k8_model_wraps_as_the_reference_int32(luma):
    """Windows of int32 extremes: every sum wraps modulo 2^32, and the
    shifts and clips act on the wrapped int32 as in the reference."""
    rng = np.random.RandomState(3 + luma)
    n = 8 if luma else 4
    phases = [(8, 8), (3, 0), (0, 5), (13, 9)] if luma else \
        [(16, 16), (5, 0), (0, 27), (31, 1)]
    for fx, fy in phases:
        for w, h in ((16, 16), (6, 6)):
            win = _windows(rng, 4, w, h, n, 10, wrap=True)
            assert np.array_equal(k8_model(win, fx, fy, w, h, 10, luma),
                                  _jax_mc(win, fx, fy, w, h, 10, luma))


def test_k8_model_128x128_two_stage_equals_the_reference():
    rng = np.random.RandomState(128)
    win = _windows(rng, 1, 128, 128, 8, 10)
    assert np.array_equal(k8_model(win, 5, 11, 128, 128, 10, True),
                          _jax_mc(win, 5, 11, 128, 128, 10, True))


@pytest.mark.parametrize("luma", [True, False])
def test_k8_tasks_cover_every_output_once(luma):
    """The launch's blocks, threads and tasks (plan, mc_kernel's task
    loop, run_task's run and segment) cover every output sample of every
    window exactly once, for ragged batches and every width kind."""
    n = 8 if luma else 4
    for w, h in ((16, 16), (8, 8), (2, 2), (6, 6), (12, 8), (128, 128),
                 (4, 8)):
        for B in (1, 37, 8040) if w * h <= 256 else (1, 37):
            G, tpw, ncol, R, threads, grid, _ = k8_plan(B, w, h, n)
            assert G * tpw <= 256 or threads == 256
            hits = np.zeros((B, h, ncol * R), np.int32)
            for blk in range(grid):
                nb = min(G, B - blk * G)
                for t in range(nb * tpw):
                    g, rem = divmod(t, tpw)
                    seg, c = divmod(rem, ncol)
                    rows = slice(seg * S, min(seg * S + S, h))
                    hits[blk * G + g, rows, c * R:c * R + R] += 1
            assert (hits[:, :, :w] == 1).all(), (w, h, B)


def _cover(a, nbytes):
    """The 16-byte-aligned chunks [lo, hi) that hold nbytes from a."""
    return a & ~15, (a + nbytes + 15) & ~15


@pytest.mark.parametrize("luma", [True, False])
def test_k8_staged_copies_hold_what_each_kind_reads(luma):
    """mc_kernel's bulk copies for windows starting 0, 4, 8 and 12 bytes
    off 16-byte alignment: kinds 0 and 1 copy each window's rows half ..
    half + h into a slot of its own, kinds 2 and 3 the group's span; each
    copy is 16-byte aligned at both ends, fits its room in shared memory,
    and every word run_task reads (from the copy's lead word on) is the
    window sample it stands for."""
    n = 8 if luma else 4
    half = n // 2 - 1
    for w, h in ((16, 16), (8, 8), (2, 2), (6, 6), (12, 8), (4, 8),
                 (128, 128)):
        if w == 2 and luma:
            continue
        WW, WH = w + n - 1, h + n - 1
        WS = WW * WH
        for kind in range(4):
            B = 37
            G, _, _, _, _, grid, wbytes = k8_plan(B, w, h, n, kind)
            margin = 0 if kind < 2 else SLACK_BYTES
            assert BAR_BYTES + G * wbytes + margin <= SMEM_MAX
            for base in (4096, 4100, 4104, 4108):
                for blk in (0, grid - 1):
                    g0 = blk * G
                    nb = min(G, B - g0)
                    src = base + g0 * WS * 4
                    rows = range(h) if kind < 2 else range(WH)
                    if kind >= 2:
                        lo, hi = _cover(src, nb * WS * 4)
                        assert hi - lo <= G * wbytes + margin
                    for g in range(nb):
                        if kind < 2:
                            a = src + (g * WS + half * WW) * 4
                            lo, hi = _cover(a, h * WW * 4)
                            assert hi - lo <= wbytes
                            dst, first = g * wbytes, a
                        else:
                            dst, first = 0, src + g * WS * 4
                        assert lo % 16 == 0 and (hi - lo) % 16 == 0
                        assert dst % 16 == 0
                        lead = (first - lo) // 4 if kind < 2 else \
                            (src - lo) // 4 + g * WS
                        for r in (rows[0], rows[-1]):
                            for c in (0, WW - 1):
                                word = lead + r * WW + c
                                assert 0 <= word < (hi - lo) // 4
                                assert lo + 4 * word == first + 4 * (
                                    r * WW + c)


# ---- K10 satd -------------------------------------------------------------


def _wht(x, axis):
    """Natural-order Hadamard butterflies along axis, modulo 2^32."""
    x = np.moveaxis(x.copy(), axis, -1)
    n = x.shape[-1]
    length = 1
    while length < n:
        y = x.reshape(x.shape[:-1] + (n // (2 * length), 2, length))
        a, c = y[..., 0, :].copy(), y[..., 1, :].copy()
        y[..., 0, :], y[..., 1, :] = a + c, a - c
        x = y.reshape(x.shape)
        length *= 2
    return np.moveaxis(x, -1, axis)


def _lanes_cross(v, lo, hi):
    """Butterflies across lanes (axis -2) of half-lengths lo .. hi / 2:
    the lane whose bit m is set takes (partner - own)."""
    li = np.arange(v.shape[-2])
    m = lo
    while m < hi:
        other = v[..., li ^ m, :]
        upper = ((li & m) != 0)[:, None]
        v = np.where(upper, other - v, v + other)
        m *= 2
    return v


def _row_pass(lanes, T, P, LR):
    """A length-T Hadamard of each row held as P values a lane on LR
    consecutive lanes: in the lane, then across the row's lanes."""
    lanes = _wht(lanes, -1)
    return _lanes_cross(lanes, 1, LR)


def _uabs(x):
    return np.where(x.view(np.int32) < 0, np.uint32(0) - x, x)


def _tile_value(T, s, dc):
    if T == 8:
        return ((s + np.uint32(2)).view(np.int32) >> 2).view(np.uint32)
    s2 = s - dc + (dc.view(np.int32) >> 2).view(np.uint32)
    return ((s2 + np.uint32(1)).view(np.int32) >> 1).view(np.uint32)


def satd_model(a, b, T):
    """K10 satd on a, b [B, H, W] int32 -> [B] int32, as the kernel that
    the launch picks for this shape computes it."""
    d = a.view(np.uint32) - b.view(np.uint32)
    B, H, W = d.shape
    ntiles = (H // T) * (W // T)
    tiles = d.reshape(B, H // T, T, W // T, T).transpose(0, 1, 3, 2, 4) \
        .reshape(B, ntiles, T, T)
    if T in (4, 8) and ntiles >= 32:
        # a thread a tile: both passes in its registers
        t = _wht(_wht(tiles, -1), -2)
        vals, dc = t, t[..., 0, 0]
        s = _uabs(vals).sum(axis=(-2, -1), dtype=np.uint32)
    else:
        P = min(T, 8)
        LR = T // P
        # lane li holds row li // LR, columns (li % LR) * P .. + P
        lanes = tiles.reshape(B, ntiles, T * LR, P)
        lanes = _row_pass(lanes, T, P, LR)                 # rows: D H
        if T <= 16:
            lanes = _lanes_cross(lanes, LR, T * LR)        # columns
        else:
            # transposed through shared memory: S[u][r] = R[r][u], then
            # lane (r', c') reads S[r'][8 c' .. 8 c' + 7]
            rows = lanes.reshape(B, ntiles, T, T)
            lanes = rows.transpose(0, 1, 3, 2).reshape(B, ntiles, T * LR, P)
            lanes = _row_pass(lanes, T, P, LR)             # columns
        s = _uabs(lanes).sum(axis=(-2, -1), dtype=np.uint32)
        dc = lanes[..., 0, 0]
    vals = _tile_value(T, s, _uabs(dc))
    return vals.sum(axis=-1, dtype=np.uint32).view(np.int32)


def satd_plan(B, H, W, T):
    """(kernel, LPE, SE, WPE, threads, grid) of csrc/dist_batch.cu
    satd_plan()."""
    ntiles = (H // T) * (W // T)
    P = min(T, 8)
    tpt = T * (T // P)

    def p2(v):
        p = 1
        while 2 * p <= v:
            p *= 2
        return p
    if T in (4, 8) and ntiles >= 32:
        te = min(p2(ntiles), 256)
        return "tile", te, 1, 1, 256, -(-B // (256 // te))
    if T >= 32:
        return "block", 32, ntiles, tpt // 32, tpt, B
    if ntiles <= 32 // tpt:
        lpe, se, wpe = p2(2 * ntiles - 1) * tpt, 1, 1
    else:
        lpe, se = 32, -(-ntiles // (32 // tpt))
        wpe = min(p2(max(se // 2, 1)), 8)
    per_block = (256 // 32 // wpe) * (32 // lpe)
    return "warp", lpe, se, wpe, 256, -(-B // per_block)


@pytest.mark.parametrize("T", [1, 2, 4, 8, 16, 32, 64])
def test_satd_model_equals_the_reference(T):
    rng = np.random.RandomState(T)
    for shape, lo, hi in (((5, 64, 64), 0, 1024),
                          ((3, 64, 128), -2 ** 30, 2 ** 30),    # sums wrap
                          ((4, 128, 64), -1024, 1024),
                          ((7, 32, 16), 0, 4096),
                          ((9, 16, 16), -2 ** 31, 2 ** 31)):
        if shape[1] % T or shape[2] % T:
            continue
        a, b = (rng.randint(lo, hi, shape, dtype=np.int64).astype(np.int32)
                for _ in range(2))
        want = np.asarray(JR.satd_batch(a, b, T))
        assert np.array_equal(satd_model(a, b, T), want), (T, shape)


def test_satd_model_rectangles_and_odd_tile_counts():
    """H != W, and a tile count that is not a power of two (3 tiles of 8
    at 24x8, 15 of 64 at 192x320) or not a multiple of a warp's tiles."""
    rng = np.random.RandomState(24)
    for shape, T in (((7, 24, 8), 8), ((7, 24, 8), 4), ((2, 192, 320), 64),
                     ((3, 40, 8), 8), ((2, 24, 40), 2), ((1, 48, 16), 16)):
        a, b = (rng.randint(-4096, 4096, shape).astype(np.int32)
                for _ in range(2))
        want = np.asarray(JR.satd_batch(a, b, T))
        assert np.array_equal(satd_model(a, b, T), want), (T, shape)


@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
def test_satd_lanes_cover_every_tile_once_with_one_writer(T):
    """The lanes' kernel (satd_warp_kernel): every (element, tile) is
    taken by exactly one lane-group in one step, and every element is
    stored by exactly one thread, for small, large and ragged batches."""
    for H, W in ((16, 16), (24, 8), (8, 8), (64, 64), (64, 128), (32, 16)):
        if H % T or W % T:
            continue
        for B in (1, 13, 40):
            kern, lpe, se, wpe, threads, grid = satd_plan(B, H, W, T)
            if kern != "warp":
                continue
            ntiles = (H // T) * (W // T)
            tpt = T * (T // min(T, 8))
            seen = np.zeros((B, ntiles), np.int32)
            writes = np.zeros(B, np.int32)
            groups, epw = threads // 32 // wpe, 32 // lpe
            for blk in range(grid):
                e0 = blk * groups * epw
                for warp in range(threads // 32):
                    eg, wi = divmod(warp, wpe)
                    for lane in range(32):
                        ll = lane & (lpe - 1)
                        e = e0 + eg * epw + lane // lpe
                        li, tl = lane & (tpt - 1), ll // tpt
                        for s in range(wi, se, wpe):
                            tile = s * (lpe // tpt) + tl
                            if e < B and tile < ntiles and li == 0:
                                seen[e, tile] += 1
                        if wpe == 1 and e < B and ll == 0:
                            writes[e] += 1
                if wpe > 1:
                    for tid in range(groups):
                        if e0 + tid < B:
                            writes[e0 + tid] += 1
            assert (seen == 1).all() and (writes == 1).all(), (H, W, B)


def test_satd_plan_picks_the_thread_a_tile_form_for_large_elements():
    assert satd_plan(8040, 16, 16, 8)[0] == "warp"
    assert satd_plan(8040, 16, 16, 4)[0] == "warp"
    assert satd_plan(480, 64, 64, 8)[:2] == ("tile", 64)
    assert satd_plan(480, 64, 64, 4)[:2] == ("tile", 256)
    assert satd_plan(480, 64, 64, 64)[0] == "block"
    assert satd_plan(480, 64, 64, 16)[0] == "warp"


def test_k8_cached_arguments_equal_the_ones_computed_per_call():
    """mc_batch's cached vt_mc_batch arguments (_k8_args) equal what the
    wrapper computed at every call before the cache (_mc_plan's stage),
    for every phase, bit depths 8..12 and both planes."""
    import torch
    for luma, phases in ((True, 16), (False, 32)):
        n = 8 if luma else 4
        win = torch.zeros((1, 4 + n - 1, 4 + n - 1), dtype=torch.int32)
        for bd in (8, 10, 12):
            for fx in range(phases):
                for fy in range(phases):
                    ntaps, _, stage = IP._mc_plan(win, fx, fy, 4, 4, bd,
                                                  luma)
                    kind = (fx != 0) + 2 * (fy != 0)
                    tx, s1, o1 = stage(fx, True, kind != 3)
                    ty, s2, o2 = stage(fy, kind != 3, True)
                    pad = [0] * (8 - ntaps)
                    want = (ntaps, kind, *(tx + pad), *(ty + pad), s1, o1,
                            s2, o2, (1 << bd) - 1)
                    assert IP._k8_args(fx, fy, bd, luma) == want


def test_kernel_functions_are_looked_up_once_per_argtypes(monkeypatch):
    """kernels.function keeps one ctypes object for each (library, symbol,
    argtypes), which mc_batch and the K10 wrappers look up at every
    launch; other argtypes get an object of their own, so that neither
    changes the other's (a library of the process stands in for a
    kernel's)."""
    import ctypes
    from vvenc_tpu_torch.ops import kernels
    monkeypatch.setitem(kernels._LIBS, "process", ctypes.CDLL(None))
    monkeypatch.setattr(kernels, "_FUNCTIONS", {})
    a = kernels.function("process", "abs", [ctypes.c_int])
    assert kernels.function("process", "abs", [ctypes.c_int]) is a
    b = kernels.function("process", "abs", [ctypes.c_long])
    assert b is not a
    assert list(a.argtypes) == [ctypes.c_int]
    assert list(b.argtypes) == [ctypes.c_long]
    assert a(-7) == 7 and b(-9) == 9


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
