"""The data flow of K3's persistent kernels as the card runs them
(csrc/plan_trial.cu: plan_square_small_kernel, both C entries at 4x4 and
8x8; plan_refs_tc_kernel, the reference entry from 16x16), held in numpy
against the JAX reference
(vvenc_tpu/ops/intra_plan.py _plan_class_core, run on the CPU through its
jitted plan_class).  A CUDA kernel has no CPU mode, so this model is what
the CPU can check of the kernels' arithmetic and of the way they cut and
sum their work; tests/test_torch_kernels.py holds the kernels themselves
on the card.

Both routes walk persistent grids: block j takes the units j, j + grid,
... (a unit is NC = 256 / (KC * S) candidates at 4x4 and 8x8, KC = 2
survivors a pass; one candidate from 16x16), grid = min(units, resident
blocks x SMs).

4x4 and 8x8: a group of 2 S lanes ranks a candidate, each lane scoring
its modes once, then k scans, each for the least (score, mode) key above
the last one taken, the group's least by a butterfly; a thread
takes one line of one survivor: its prediction's main row as a run
(intra_pred.cuh pred_run: a row's taps and R + 3 reference values read
once), then a row (forward rows, inverse rows) or a column (forward and
inverse columns, quantisation in the second) of each product on the CUDA
cores.  A survivor's sums go over its S lanes by a butterfly (xor S / 2
.. 1), each lane's log2 sum first over its column in order.

16x16 .. 64x64 (the reference entry; the preds form keeps
plan_trial_tc_kernel, whose order of sums this repeats): warp 0 ranks by
a warp argmin, warp 1 sums DC; runs of 4 along the main rows; the four
products as int8 tiles (m16n8k32, the data operand split into a signed
high and an unsigned low byte, the matrix s8): a^T[u][y] = tw r^T,
c[v][u] = th a, a2[y][u] = th^T d^T, r[y][x] = a2 tw. At 64x64 the
second product computes only the 32x32 coefficients the zero-out keeps
and the third and fourth contract over those 32. Warp w takes tiles w, w
+ NW, ... of its survivor (NW = 2 at 16x16, 8 above); a thread's log2
sum runs over its tiles in order, then a warp butterfly (xor 16 .. 1),
then the warps in order.

Log2 terms of zero levels are skipped (log2(1 + 0) adds 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vvenc_tpu.ops.intra_plan as JL
import vvenc_tpu_torch.ops.intra_plan as TL
import vvenc_tpu_torch.ops.intra_presel as TS
from vvenc_tpu_torch.ops.tables import FLAG_ANG0, FLAG_PDPC, FLAG_VER
from vvenc_tpu_torch.ops.tables import _angular_tables
from vvenc_tpu_torch.ops.transforms import tr_matrix

F32 = np.float32
CMIN, CMAX = -(1 << 15), (1 << 15) - 1
KC, THREADS = 2, 256


def nc_of(s):
    """Candidates a unit of the persistent walk: NC at 4x4 and 8x8, 1 from
    16x16."""
    return THREADS // (KC * s) if s < 16 else 1


def walk(B, unit, grid):
    """The candidates each block takes, in order: units j, j + grid, ..."""
    units = -(-B // unit)
    return [[b for u in range(j, units, grid)
             for b in range(u * unit, min(B, (u + 1) * unit))]
            for j in range(min(grid, units))]


# ---------------------------------------------------------------------------
# the ranking
# ---------------------------------------------------------------------------

def scores(satd, ls):
    """satd + mode_bits * lambda_sad in float32, that order: [B, M]."""
    return satd.astype(F32) + (TL._MODE_BITS[None, :satd.shape[1]]
                               * ls[:, None].astype(F32)).astype(F32)


def rank_group(sc, k, W):
    """A group of W lanes (W a power of two): lane j scores modes j, j +
    W, ... once, then k scans, each lane's least (score, mode) key above
    the last one taken, and the group's least by an xor butterfly."""
    M = len(sc)
    top, last = [], (-np.inf, -1)
    for _ in range(k):
        best = []
        for sub in range(W):
            b = (np.inf, 0x7FFFFFFF)
            for m in range(sub, M, W):
                v = sc[m]
                if ((v > last[0] or (v == last[0] and m > last[1]))
                        and (v < b[0] or (v == b[0] and m < b[1]))):
                    b = (v, m)
            best.append(b)
        o = W >> 1
        while o:
            best = [min(best[j], best[j ^ o]) for j in range(W)]
            o >>= 1
        top.append(best[0][1])
        last = best[0]
    return top


def rank_warp(sc, k):
    """Warp 0's argmin: lane l holds modes l, l + 32, l + 64; k rounds of
    a local best among the untaken and a butterfly."""
    M = len(sc)
    taken = np.zeros(96, bool)
    top = []
    for _ in range(k):
        best = []
        for lane in range(32):
            bs, bm = np.inf, 0x7FFFFFFF
            for j in range(3):
                m = lane + 32 * j
                if m < M and not taken[m] and (
                        sc[m] < bs or (sc[m] == bs and m < bm)):
                    bs, bm = sc[m], m
            best.append((bs, bm))
        for o in (16, 8, 4, 2, 1):
            best = [min(best[lane], best[lane ^ o]) for lane in range(32)]
        taken[best[0][1]] = True
        top.append(best[0][1])
    return top


# ---------------------------------------------------------------------------
# the survivors' predictions
# ---------------------------------------------------------------------------

def pools(tops, lefts, s):
    """Each candidate's pool [top | ftop | left | fleft] (int64)."""
    L = 2 * s + 3
    top, left = tops[:, :L].astype(np.int64), lefts[:, :L].astype(np.int64)
    corner = (top[:, 0] + top[:, 1] + left[:, 0] + left[:, 1] + 2) >> 2

    def filt(x):
        f = np.repeat(x[:, 2 * s:2 * s + 1], L, axis=1)
        f[:, 0] = corner
        f[:, 1:2 * s] = (x[:, :2 * s - 1] + 2 * x[:, 1:2 * s]
                         + x[:, 2:2 * s + 1] + 2) >> 2
        return f
    return np.concatenate([top, filt(top), left, filt(left)], axis=1)


def planar_dc(pool, s, bd, mode):
    """intra_pred.cuh planar_dc_sample at every (y, x) of a square class:
    [B, s, s]."""
    L = 2 * s + 3
    lg = s.bit_length() - 1
    mdis = mode == 0 and s * s > 32
    ptop = pool[:, L:] if mdis else pool
    pleft = pool[:, 3 * L:] if mdis else pool[:, 2 * L:]
    yy = np.arange(s)[None, :, None]
    xx = np.arange(s)[None, None, :]
    lc, trr = pleft[:, 1:s + 1, None], ptop[:, None, 1:s + 1]
    if mode == 0:
        tr, br = ptop[:, s + 1, None, None], pleft[:, s + 1, None, None]
        hor = lc * (1 << lg) + (xx + 1) * (tr - lc)
        ver = trr * (1 << lg) + (yy + 1) * (br - trr)
        v = (hor * (1 << lg) + ver * (1 << lg) + (1 << (2 * lg))) >> (
            1 + 2 * lg)
    else:
        tot = pool[:, 1:s + 1].sum(1) + pool[:, 2 * L + 1:2 * L + s + 1] \
            .sum(1)
        v = ((tot + s) >> (lg + 1))[:, None, None]
    scale = ((s * s).bit_length() - 1 - 2) >> 2
    wt = 32 >> np.minimum(31, (yy << 1) >> scale)
    wl = 32 >> np.minimum(31, (xx << 1) >> scale)
    v = v + ((wl * (lc - v) + wt * (trr - v) + 32) >> 6)
    return np.clip(v, 0, (1 << bd) - 1)


def pred_runs(pool, a, s, bd, mode, R):
    """Mode `mode`'s prediction [B, s, s] as pred_run computes it in runs
    of R along each main row (planar, DC and the vertical modes along y,
    the horizontal ones along x): a run reads its row's taps once and the
    R + 3 reference values of its window once, which stays inside the
    mode's row of rm_flat.  The per-sample arithmetic is pred_sample's,
    so the runs are taken all at once here."""
    maxv = (1 << bd) - 1
    if mode < 2:
        return planar_dc(pool, s, bd, mode)
    mi = mode - 2
    shift, rnd, flags = (int(v) for v in a["mode_info"][mi, :3])
    p16 = pool.astype(np.int16).astype(np.int64)
    rm = a["rm_flat"][mi]
    rs = a["row_start"][mi, :s].astype(np.int64)
    starts = rs[:, None] + np.arange(s)[None, :]       # [row, col]
    assert (rs[:, None] + np.arange(0, s, R)[None, :] + R + 3).max() \
        <= a["LR"]                                     # windows in the row
    f = a["filt"][mi, :s].astype(np.int64)             # [row, 4]
    acc = sum(f[None, :, j, None] * p16[:, rm[starts + j]] for j in
              range(4))
    v = np.clip((acc + rnd) >> shift, 0, maxv)         # [B, row, col]
    if flags & FLAG_PDPC:
        wl = a["pdpc_wl"][mi, :s].astype(np.int64)[None, None, :]
        lval = p16[:, a["side_flat"][mi, :s, :s]]
        if flags & FLAG_ANG0:
            tl = p16[:, rm[a["B0"]]][:, None, None]
            v = np.where(wl != 0, np.clip(
                v + ((wl * (lval - tl) + 32) >> 6), 0, maxv), v)
        else:
            v = np.where(wl != 0, v + ((wl * (lval - v) + 32) >> 6), v)
    v = np.clip(v, 0, maxv)
    return v if flags & FLAG_VER else v.transpose(0, 2, 1)


def prediction(pool, a, s, bd, modes, R):
    """The survivors' predictions [B, s, s] (modes [B])."""
    out = np.zeros((len(modes), s, s), np.int64)
    for m in np.unique(modes):
        sel = modes == m
        out[sel] = pred_runs(pool[sel], a, s, bd, int(m), R)
    return out


# ---------------------------------------------------------------------------
# the trials
# ---------------------------------------------------------------------------

def rshift(v, n):
    return np.clip((v + (1 << (n - 1))) >> n, CMIN, CMAX)


def split_product(T, X, kp):
    """T [m, K] s8 times X [K, n] (in [-2^15, 2^15)) as the tiles compute
    it, the contraction cut to its first kp points: the high and low
    byte products apart, every partial inside int32, recombined."""
    hi, lo = X >> 8, X & 255
    assert hi.min() >= -128 and hi.max() <= 127 and np.abs(T).max() <= 127
    ph = T[:, :kp] @ hi[..., :kp, :]
    pl = T[:, :kp] @ lo[..., :kp, :]
    for v in (ph, pl, 256 * ph, 256 * ph + pl):
        assert np.abs(v).max() < 2 ** 31
    return 256 * ph + pl


def quant(c, p):
    """Levels (|c| * scale + add >> qbits in wrapping int32, c's sign),
    their magnitudes and the clipped dequantised coefficients."""
    a = np.abs(c).astype(np.uint32)
    mag = ((a * np.uint32(p["qscale"]) + np.uint32(p["qadd"]))
           .astype(np.int32) >> p["qbits"]).astype(np.int64)
    q = np.sign(c) * mag
    qc = np.clip(q, CMIN, CMAX)
    if p["dshift"] > 0:
        d = (qc * p["dscale"] + (1 << (p["dshift"] - 1))) >> p["dshift"]
    else:
        d = (qc * p["dscale"]) << (-p["dshift"])
    return q, mag, np.clip(d, CMIN, CMAX)


def log_term(slog, mag):
    """slog + log2(1 + mag) in float32, skipped for a zero level."""
    t = np.log2(F32(1) + mag.astype(F32)).astype(F32)
    return np.where(mag != 0, (slog + t).astype(F32), slog)


def butterfly(v, width):
    """A segmented xor butterfly over lanes [..., width] (float32):
    every lane ends with lane 0's sum."""
    for o in [width >> i for i in range(1, width.bit_length())]:
        idx = np.arange(width) ^ o
        v = (v + v[..., idx]).astype(v.dtype)
    return v[..., 0]


def small_trial(src, pred, tw, th, p):
    """A 4x4 / 8x8 survivor, a thread a line: (sse, nnz, slog) [B]."""
    s = src.shape[1]
    r = src - pred
    a = rshift(r @ tw.T, p["shift1"])                  # rows: [y][u]
    c = rshift(th @ a, p["shift2"])                    # columns: [v][u]
    q, mag, d = quant(c, p)
    # lane u sums its column's terms v = 0 .. s - 1, then the butterfly
    lane = np.zeros((len(src), s), F32)
    for v in range(s):
        lane = log_term(lane, mag[:, v, :])
    slog = butterfly(lane, s)
    a2 = rshift(th.T @ d, 7)                           # columns: [y][u]
    r2 = rshift(a2 @ tw, p["ishift2"])                 # rows: [y][x]
    rec = np.clip(pred + r2, 0, p["maxval"])
    sse = ((src - rec) ** 2).sum((1, 2))
    return sse, (q != 0).sum((1, 2)), slog


def tc_trial(src, pred, tw, th, p):
    """A 16x16 .. 64x64 survivor through the split tiles: (sse, nnz,
    slog) [B]."""
    B, s, _ = src.shape
    s32 = min(s, 32)
    kp3 = 32 if s > 32 else max(s, 32)
    r = src - pred
    aT = rshift(split_product(tw, r.transpose(0, 2, 1), s),
                p["shift1"])                           # [u][y]
    cT = rshift(split_product(th[:s32], aT[:, :s32].transpose(0, 2, 1), s)
                .transpose(0, 2, 1), p["shift2"])      # [u][v], u, v < s32
    q, mag, d = quant(cT, p)
    # the warps' tiles of the second product (m over v, n over u) in
    # order, 4 terms a tile, the tiles the zero-out drops skipped
    NW = 2 if s == 16 else 8
    lanes = np.zeros((B, NW, 32), F32)
    g, t4 = np.arange(32) >> 2, np.arange(32) & 3
    for tt in range((s // 16) * (s // 8)):
        w = tt % NW
        m0, n0 = (tt // (s // 8)) * 16, (tt % (s // 8)) * 8
        if m0 >= s32 or n0 >= s32:
            continue
        for e in range(4):
            v, u = m0 + g + 8 * (e >> 1), n0 + 2 * t4 + (e & 1)
            lanes[:, w] = log_term(lanes[:, w], mag[:, u, v])
    warps = butterfly(lanes, 32)
    slog = np.zeros(B, F32)
    for w in range(NW):
        slog = (slog + warps[:, w]).astype(F32)
    dfull = np.zeros((B, s, s), np.int64)
    dfull[:, :s32, :s32] = d                           # [u][v]
    a2 = rshift(split_product(th.T, dfull.transpose(0, 2, 1), kp3)
                [:, :, :s32], 7)                       # [y][u], u < s32
    a2f = np.zeros((B, s, s), np.int64)
    a2f[:, :, :s32] = a2
    r2 = rshift(split_product(tw.T, a2f.transpose(0, 2, 1), kp3)
                .transpose(0, 2, 1), p["ishift2"])     # [y][x]
    rec = np.clip(pred + r2, 0, p["maxval"])
    sse = ((src - rec) ** 2).sum((1, 2))
    return sse, (q != 0).sum((1, 2)), slog


def k3_model(src, tops, lefts, satd, lm, ls, s, qp, bd, k, refs=True,
             preds=None, grid=3):
    """K3's square route in numpy: the persistent walk, the ranking, the
    survivors' predictions (refs: runs from the references; else K1's
    preds [B, 67, s, s]) and the trials -> (modes [B, k] int32, costs
    [B, k] float32)."""
    p = TL._trial_params(s, s, qp, bd, True)
    tw = tr_matrix(s, p["trh"]).astype(np.int64)
    th = tr_matrix(s, p["trv"]).astype(np.int64)
    a = _angular_tables(s, s)
    B = len(src)
    blocks = walk(B, nc_of(s), grid)
    order = [b for blk in blocks for b in blk]
    assert sorted(order) == list(range(B))             # each candidate once
    sc = scores(satd, ls)
    modes = np.array([rank_group(sc[b], k, KC * s) if s < 16
                      else rank_warp(sc[b], k) for b in range(B)], np.int64)
    pool = pools(tops, lefts, s)
    src64 = src.astype(np.int64)
    costs = np.zeros((B, k), F32)
    trial = small_trial if s < 16 else tc_trial
    for i in range(k):
        m = modes[:, i]
        if refs:
            pred = prediction(pool, a, s, bd, m, s if s < 16 else 4)
        else:
            pred = preds[np.arange(B), m].astype(np.int64)
        sse, nnz, slog = trial(src64, pred, tw, th, p)
        bits = np.where(nnz > 0, (F32(TL.RATE_C0) + F32(TL.RATE_C1)
                                  * nnz.astype(F32)).astype(F32)
                        + (F32(TL.RATE_C2) * slog).astype(F32),
                        F32(1)).astype(F32)
        costs[:, i] = (sse.astype(F32) + lm.astype(F32) * (
            bits + TL._MODE_BITS[m]).astype(F32)).astype(F32)
    return modes.astype(np.int32), costs


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _inputs(s, bd, B, seed, flat=0):
    """B of planning's class inputs from random-walk planes (the first
    `flat` candidates' references one value: their angular predictions
    all equal, so their SATD rows tie), with lambdas."""
    rng = np.random.RandomState(seed)
    top = (1 << bd) - 1
    W, H = 64 if s < 64 else 128, 64
    walk_ = np.cumsum(rng.randint(-9, 10, (2, H, W)), axis=2)
    srcs = np.clip(walk_ + top // 2 + rng.randint(-20, 21, (2, H, W)), 0,
                   top).astype(np.int16)
    srcs[0, :8] = top
    planes = torch.from_numpy(np.stack(
        [np.pad(x, TL.PAD, mode="edge") for x in srcs]))
    blocks, tops, lefts = TL._class_inputs(planes, s, W, H)
    idx = np.arange(B) % blocks.shape[0]
    blocks, tops, lefts = (x.numpy()[idx].copy() for x in (blocks, tops,
                                                           lefts))
    tops[:flat] = lefts[:flat] = top // 3
    lm = rng.uniform(10, 100, B).astype(F32)
    return blocks, tops, lefts, lm, np.sqrt(lm).astype(F32)


def _jax(blocks, tops, lefts, lm, ls, s, qp, bd, k):
    m, c = JL.plan_class(*(jnp.asarray(x) for x in (blocks, tops, lefts, lm,
                                                    ls)),
                         w=s, h=s, qp=qp, bit_depth=bd, implicit_mts=True,
                         k=k)
    return np.asarray(m), np.asarray(c)


# B: a unit of the walk does not divide it (NC = 32 at 4x4, 16 at 8x8)
CASES = [(4, 37), (8, 21), (16, 7), (32, 5), (64, 3)]


@pytest.mark.parametrize("bd,qp", [(8, 27), (10, 43)])
@pytest.mark.parametrize("s,B", CASES)
def test_k3r_model_equals_jax_plan_class_core(s, B, bd, qp):
    """The model's modes equal JAX's _plan_class_core's for k = 1, 2 and 3
    (top-k is sorted: k = 1 and 2 are k = 3's first columns) and its costs
    are within rtol 1e-5 (float32 sums in another order than XLA's), on
    class inputs with a few tied SATD rows, through the reference entry
    and through the preds form on K1's predictions (equal results)."""
    blocks, tops, lefts, lm, ls = _inputs(s, bd, B, 5 * s + bd, flat=2)
    mj, cj = _jax(blocks, tops, lefts, lm, ls, s, qp, bd, 3)
    satd = TS.presel_costs(*(torch.from_numpy(x) for x in
                             (blocks, tops, lefts)), s, s, bd).numpy()
    assert (satd[0] == satd[0, 2]).sum() > 30         # a tied row
    preds = TS.predict_all_modes_ref(torch.from_numpy(tops),
                                     torch.from_numpy(lefts), s, s,
                                     bd).numpy()
    for k in (1, 2, 3):
        mk, ck = k3_model(blocks, tops, lefts, satd, lm, ls, s, qp, bd, k)
        np.testing.assert_array_equal(mk, mj[:, :k])
        np.testing.assert_allclose(ck, cj[:, :k], rtol=1e-5, atol=0)
    mp, cp = k3_model(blocks, tops, lefts, satd, lm, ls, s, qp, bd, 3,
                      refs=False, preds=preds)
    np.testing.assert_array_equal(mp, mk)
    np.testing.assert_array_equal(cp, ck)


@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_k3r_prediction_runs_equal_k1(s):
    """pred_run's runs (4 samples from 16x16, a whole row at 4x4 and 8x8)
    rebuild all 67 predictions of K1's plain version
    (predict_all_modes_ref, held to JAX's predict_all_modes by
    tests/test_torch_intra_presel.py) bit for bit, references at random
    values, the rails and a hard edge."""
    bd, B = 10, 3
    rng = np.random.RandomState(s)
    L = 2 * s + 3
    tops = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    lefts = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    tops[0] = lefts[1] = (1 << bd) - 1
    tops[1] = lefts[0] = 0
    tops[2, :L // 2] = 0
    want = TS.predict_all_modes_ref(torch.from_numpy(tops),
                                    torch.from_numpy(lefts), s, s,
                                    bd).numpy()
    pool = pools(tops, lefts, s)
    a = _angular_tables(s, s)
    R = s if s < 16 else 4
    for m in range(67):
        got = prediction(pool, a, s, bd, np.full(B, m), R)
        np.testing.assert_array_equal(got, want[:, m], err_msg=f"mode {m}")


@pytest.mark.parametrize("M", [67, 35, 1])
def test_k3r_rankings_equal_a_stable_sort(M):
    """Both rankings (a group of lanes a candidate; the warp argmin) give
    the stable sort's first k modes, ties to the lowest mode: random
    rows, all-equal rows, rows of a few values, infinities."""
    rng = np.random.RandomState(M)
    rows = [rng.uniform(0, 100, M).astype(F32), np.full(M, 7, F32),
            rng.randint(0, 3, M).astype(F32),
            np.where(rng.rand(M) < 0.5, np.inf, 1).astype(F32)]
    for sc in rows:
        want = np.argsort(sc, kind="stable")
        for k in sorted({1, 2, 3, M} & set(range(1, M + 1))):
            for W in (8, 16):                       # 4x4, 8x8
                assert rank_group(sc, k, W) == list(want[:k])
            assert rank_warp(sc, k) == list(want[:k])


@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_k3r_walk_covers_every_candidate_once(s):
    """The persistent grid takes every candidate once whatever B and the
    grid: B = 1, below a unit, a unit not dividing B, one past a full
    wave."""
    unit = nc_of(s)
    for grid in (1, 3, 132 * 4):
        for B in (1, unit - 1 or 1, 3 * unit + 5, grid * unit + 1):
            order = [b for blk in walk(B, unit, grid) for b in blk]
            assert sorted(order) == list(range(B))
            assert len(walk(B, unit, grid)) == min(grid, -(-B // unit))
