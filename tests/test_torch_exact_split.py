"""The exactness arguments of the kernels redesigned for the H100 (K3
plan_trial, K4 presel_costs, K5 frame_me, K6 transform_batch, K9
full_search_sse, K11 mode_costs), held in numpy against integer
arithmetic and the port's plain versions.

K4 runs its per-sample arithmetic on the float32 pipe: every value is an
integer below 2^24, and each (x + 32) >> 6 is one fused multiply-add of
x + 0.5 by 1/64 onto 1.5 * 2^23, which rounds to the floor because the
argument is never a half-integer.  _k4_model repeats the kernel's data
flow (the per-mode pool-position lists of ops/tables.presel_mode_tables,
the rows' windows, PDPC, the float rounding, the Hadamard butterflies in
the kernel's order) with numpy: a float64 value that is exact, cast to
float32, is the fused multiply-add's single rounding.
"""

import numpy as np
import pytest
import torch

from vvenc_tpu_torch.ops import intra_presel as S
from vvenc_tpu_torch.ops.intra_vec import _shape_tables
from vvenc_tpu_torch.ops.tables import (FLAG_ANG0, FLAG_PDPC, FLAG_VER,
                                        presel_mode_tables)

MAGIC = np.float32(1.5 * 2 ** 23)
MTT_SHAPES = S.shapes_for_config(128, 2)[0]


def _fma_magic(x):
    """The kernel's __fmaf_rn(x, 1/64, 1.5 * 2^23): exact in float64,
    rounded once to float32."""
    return (np.asarray(x, np.float64) / 64.0 + float(MAGIC)).astype(
        np.float32)


def _wht_rows(d, last=None):
    """Natural-order Hadamard along the last axis, the kernel's butterfly
    order, in float32 (exact: every partial sum is an integer < 2^24);
    with `last`, only the stages of length < last."""
    d = d.copy()
    T = d.shape[-1]
    ln = 1
    while ln < (last or T):
        for i in range(0, T, 2 * ln):
            for j in range(i, i + ln):
                a, c = d[..., j].copy(), d[..., j + ln].copy()
                d[..., j] = a + c
                d[..., j + ln] = a - c
        ln <<= 1
    return d


def _k4_model(blocks, tops, lefts, w, h, bd):
    """K4's arithmetic on the reference's inputs (blocks [B, h, w], tops
    [B, >=2w+3], lefts [B, >=2h+3], int32) -> costs [B, 67] int32."""
    lpad = _shape_tables(w, h, True, 0).LPAD
    nA, nL = min(tops.shape[1], lpad), min(lefts.shape[1], lpad)
    tab = presel_mode_tables(w, h, nA, nL)
    top, left = tops[:, :nA].astype(np.int64), lefts[:, :nL].astype(np.int64)
    B = len(blocks)
    corner = (top[:, 0] + top[:, 1] + left[:, 0] + left[:, 1] + 2) >> 2

    def filt(r, n):
        f = r.copy()
        f[:, 1:n] = (r[:, :n - 1] + 2 * r[:, 1:n] + r[:, 2:n + 1] + 2) >> 2
        f[:, 0] = corner
        f[:, n:] = r[:, n:n + 1]
        return f
    pool_i = np.concatenate([top, filt(top, 2 * w), left, filt(left, 2 * h)],
                            axis=1).astype(np.int16).astype(np.int64)
    pool = pool_i.astype(np.float32)
    srcm = blocks.astype(np.int16).astype(np.float32) + MAGIC
    maxval = (1 << bd) - 1
    vmax = MAGIC + np.float32(maxval)
    T = 8 if (w % 8 == 0 and h % 8 == 0) else 4
    preds = np.zeros((B, 67, h, w), np.float32)      # magic domain
    for m in range(65):
        flags, SB, TL, n = tab["minfo"][m]
        ver = bool(flags & FLAG_VER)
        rows, cols = (h, w) if ver else (w, h)
        vals = pool[:, tab["gidx"][m, :n]]
        tl = vals[:, TL] if flags & FLAG_ANG0 else None
        for r in range(rows):
            f = tab["taps"][m, r]
            c = np.arange(cols)
            win = vals[:, tab["rs"][m, r] + c[:, None] + np.arange(4)]
            acc = 0.5 + win[..., 0] * f[0]
            for k in (1, 2, 3):
                acc = acc + win[..., k] * f[k]
            y = np.minimum(np.maximum(_fma_magic(acc), MAGIC), vmax)
            if flags & FLAG_PDPC:
                for x in range(min(cols, len(tab["wl"][m]))):
                    wl = tab["wl"][m, x]
                    if wl == 0:
                        continue
                    lval = vals[:, SB + r + tab["soff"][m, x]]
                    v = y[:, x] - MAGIC
                    base = (lval - tl) if tl is not None else (lval - v)
                    q = _fma_magic(base * wl + 0.5) - MAGIC
                    y[:, x] = np.minimum(np.maximum(v + q + MAGIC, MAGIC),
                                         vmax)
            if ver:
                preds[:, m + 2, r, :] = y
            else:
                preds[:, m + 2, :, r] = y
    # planar and DC, in integers as the kernel computes them
    ref = S.predict_all_modes_ref(torch.from_numpy(tops),
                                  torch.from_numpy(lefts), w, h, bd).numpy()
    preds[:, :2] = ref[:, :2].astype(np.float32) + MAGIC
    d = srcm[:, None] - preds                         # [B, 67, h, w]
    d = d.reshape(B, 67, h // T, T, w // T, T).transpose(0, 1, 2, 4, 3, 5)
    d = _wht_rows(d)                                  # rows
    d = np.swapaxes(_wht_rows(np.swapaxes(d, -1, -2)), -1, -2)  # columns
    s = np.abs(d).sum(axis=(-1, -2), dtype=np.float32).astype(np.int64)
    if T == 8:
        val = (s + 2) >> 2
    else:
        dct = np.abs(d[..., 0, 0]).astype(np.int64)
        val = ((s - dct + (dct >> 2)) + 1) >> 1
    return val.sum(axis=(2, 3)).astype(np.int32)


def _inputs(rng, B, w, h, bd, kind):
    top = (1 << bd) - 1
    L = _shape_tables(w, h, True, 0).LPAD
    if kind == "checker":
        # 0 / max checkerboards drive every residual to its extreme
        yy, xx = np.mgrid[:h, :w]
        blocks = np.where((yy + xx) % 2 == 0, top, 0)[None].repeat(B, 0)
        blocks[1::2] = top - blocks[1::2]
        tops = np.where(np.arange(L) % 2 == 0, 0, top)[None].repeat(B, 0)
        lefts = np.where(np.arange(L) % 2 == 0, top, 0)[None].repeat(B, 0)
        tops[::3] = top - tops[::3]
    else:
        blocks = rng.randint(0, top + 1, (B, h, w))
        tops = rng.randint(0, top + 1, (B, 2 * w + 3))
        lefts = rng.randint(0, top + 1, (B, 2 * h + 3))
        tops[0], lefts[0] = top, top
        tops[1], lefts[1] = 0, 0
    return (np.ascontiguousarray(blocks, np.int32),
            np.ascontiguousarray(tops, np.int32),
            np.ascontiguousarray(lefts, np.int32))


@pytest.mark.parametrize("kind", ["random", "checker"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", MTT_SHAPES)
def test_k4_float_algebra_equals_the_plain_version(w, h, bd, kind):
    """K4's float32 data flow gives presel_costs_ref's integer costs, on
    random samples and on 0 / max checkerboards, every MTT class (the
    references 2w+3 / 2h+3 wide, so the rectangular misreads and the
    clamp past the pool's end are covered)."""
    rng = np.random.RandomState(w * 97 + h * 5 + bd)
    B = 6 if w * h >= 1024 else 11
    blocks, tops, lefts = _inputs(rng, B, w, h, bd, kind)
    want = S.presel_costs_ref(torch.from_numpy(blocks),
                              torch.from_numpy(tops),
                              torch.from_numpy(lefts), w, h, bd).numpy()
    np.testing.assert_array_equal(_k4_model(blocks, tops, lefts, w, h, bd),
                                  want)


def test_k4_shift_by_fma_onto_the_magic_number_is_the_floor():
    """(x + 32) >> 6 == rint((x + 0.5) / 64) through 1.5 * 2^23, for every
    x the 4-tap sums and the PDPC products can reach (|x| < 2^18), and the
    residual's float32 difference is exact."""
    x = np.arange(-(1 << 18), 1 << 18, dtype=np.int64)
    got = _fma_magic(x + 0.5).astype(np.float64) - float(MAGIC)
    np.testing.assert_array_equal(got.astype(np.int64), (x + 32) >> 6)
    v = np.arange(0, 1 << 12, dtype=np.float32) + MAGIC
    assert np.array_equal((MAGIC + np.float32(1023)) - v,
                          (1023 - np.arange(1 << 12)).astype(np.float32))


# ---------------------------------------------------------------------------
# K3: the int8 tensor-core products of the 16x16 .. 64x64 trials
# ---------------------------------------------------------------------------

def _split(x):
    """x (int, in [-2^15, 2^15)) -> (hi s8, lo u8) with x = 256 hi + lo,
    the kernel's byte planes."""
    x = np.asarray(x, np.int64)
    hi, lo = x >> 8, x & 255
    assert hi.min() >= -128 and hi.max() <= 127
    assert lo.min() >= 0 and lo.max() <= 255
    return hi.astype(np.int8), lo.astype(np.uint8)


def _split_product(T, X):
    """T @ X as the kernel computes it: int8 x int8 and int8 x uint8
    products accumulated in int32, recombined as 256 * hi + lo in int32;
    asserts every partial sum stays inside int32."""
    hi, lo = _split(X)
    T8 = np.asarray(T, np.int64)
    assert T8.min() >= -128 and T8.max() <= 127
    ph = T8 @ hi.astype(np.int64)
    pl = T8 @ lo.astype(np.int64)
    for a in (ph, pl, 256 * ph, 256 * ph + pl):
        assert np.abs(a).max() < 2 ** 31
    return (256 * ph + pl).astype(np.int32)


@pytest.mark.parametrize("n,tt", [(n, "DCT2") for n in (4, 8, 16, 32, 64)]
                         + [(n, "DST7") for n in (4, 8, 16, 32)])
def test_k3_int8_split_products_equal_int64_at_the_extremes(n, tt):
    """Every transform size's matrix (ops/transforms.tr_matrix) times
    operands at the extremes the trial reaches: residuals +-(2^bd - 1) at
    8 and 10 bits, clipped stage results and dequantised levels -2^15 and
    2^15 - 1, signs chosen to maximise each output; equal to int64."""
    from vvenc_tpu_torch.ops import transforms as TR
    T = TR.tr_matrix(n, getattr(TR, tt)).astype(np.int64)
    assert np.abs(T).max() <= 91
    rng = np.random.RandomState(n)
    sign = np.where(T >= 0, 1, -1)                 # worst case per row
    for lo_v, hi_v in (((1 << 8) - 1,) * 2, ((1 << 10) - 1,) * 2,
                       (1 << 15, (1 << 15) - 1)):
        cols = [np.where(sign[u] > 0, hi_v, -lo_v) for u in range(n)]
        X = np.stack(cols, axis=1)                 # [n, n]: column u
        X = np.concatenate([X, rng.randint(-lo_v, hi_v + 1, (n, 5)),
                            np.full((n, 1), -lo_v), np.full((n, 1), hi_v)],
                           axis=1)
        got = _split_product(T, X)
        np.testing.assert_array_equal(got, T @ X.astype(np.int64))


def _k3_model(src, preds, satd, lm, ls, s, qp, bd, k):
    """K3's tensor-core route in numpy: the ranking by (score, mode), the
    four products through _split_product, the kernel's epilogues ->
    (modes [B, k] int32, costs [B, k] float32)."""
    from vvenc_tpu_torch.ops import intra_plan as P
    from vvenc_tpu_torch.ops.transforms import tr_matrix
    p = P._trial_params(s, s, qp, bd, True)
    tw = tr_matrix(s, p["trh"]).astype(np.int64)
    th = tr_matrix(s, p["trv"]).astype(np.int64)
    mb = P._MODE_BITS
    lo_c, hi_c = -(1 << 15), (1 << 15) - 1

    def rs(v, n):
        return np.clip((v.astype(np.int64) + (1 << (n - 1))) >> n, lo_c,
                       hi_c)
    B = len(src)
    modes = np.zeros((B, k), np.int32)
    costs = np.zeros((B, k), np.float32)
    for b in range(B):
        score = (satd[b].astype(np.float32)
                 + (mb * np.float32(ls[b])).astype(np.float32))
        top = np.argsort(score, kind="stable")[:k]
        for i, m in enumerate(top):
            pred = preds[b, m].astype(np.int64)
            r = src[b].astype(np.int64) - pred
            a = rs(_split_product(tw, r.T).T, p["shift1"])     # [y][u]
            c = rs(_split_product(th, a), p["shift2"])          # [v][u]
            if s > 32:
                c[32:, :] = 0
                c[:, 32:] = 0
            q = quant_model(c, p)
            d = np.clip(dequant_model(q, p), lo_c, hi_c)
            a2 = rs(_split_product(th.T, d), 7)                # [y][u]
            r2 = rs(_split_product(tw.T, a2.T).T, p["ishift2"])  # [y][x]
            rec = np.clip(pred + r2, 0, p["maxval"])
            sse = float(((src[b] - rec) ** 2).sum())
            nnz = float((q != 0).sum())
            slog = np.float32(np.log2(1.0 + np.abs(q).astype(np.float32))
                              .astype(np.float32).sum(dtype=np.float32))
            bits = (np.float32(P.RATE_C0) + np.float32(P.RATE_C1) * nnz
                    + np.float32(P.RATE_C2) * slog) if nnz > 0 else 1.0
            modes[b, i] = m
            costs[b, i] = np.float32(sse) + np.float32(lm[b]) * np.float32(
                np.float32(bits) + mb[m])
    return modes, costs


def quant_model(c, p):
    """|c| * scale + add >> qbits in wrapping int32, with c's sign."""
    a = np.abs(c).astype(np.uint32)
    mag = ((a * np.uint32(p["qscale"]) + np.uint32(p["qadd"]))
           .astype(np.int32) >> p["qbits"]).astype(np.int64)
    return np.sign(c) * mag


def dequant_model(q, p):
    qc = np.clip(q, -(1 << 15), (1 << 15) - 1)
    if p["dshift"] > 0:
        return (qc * p["dscale"] + (1 << (p["dshift"] - 1))) >> p["dshift"]
    return (qc * p["dscale"]) << (-p["dshift"])


@pytest.mark.parametrize("qp", [0, 22, 51])
@pytest.mark.parametrize("s", [16, 32, 64])
def test_k3_tensor_core_route_equals_the_plain_version(s, qp):
    """The split-int8 data flow gives plan_trial_ref's modes and its costs
    within rtol 1e-5, on residuals at their extremes (0 / max sources
    against max / 0 predictions) and at QP 0 and 51; ties (all-equal
    SATD rows) go to the lowest mode."""
    from vvenc_tpu_torch.ops import intra_plan as P
    bd, k, B, M = 10, 2, 3, 67
    rng = np.random.RandomState(s + qp)
    top = (1 << bd) - 1
    src = rng.randint(0, top + 1, (B, s, s)).astype(np.int32)
    src[0] = np.where(np.indices((s, s)).sum(0) % 2 == 0, top, 0)
    preds = rng.randint(0, top + 1, (B, M, s, s)).astype(np.int16)
    preds[0] = (top - src[0])[None].astype(np.int16)
    satd = rng.randint(0, 5000, (B, M)).astype(np.int32)
    satd[1] = 1234                                   # ties
    lm = rng.uniform(10, 100, B).astype(np.float32)
    ls = np.sqrt(lm).astype(np.float32)
    slice_qp = qp
    mk, ck = _k3_model(src, preds, satd, lm, ls, s, slice_qp, bd, k)
    mr, cr = P.plan_trial_ref(torch.from_numpy(src), torch.from_numpy(preds),
                              torch.from_numpy(satd), torch.from_numpy(lm),
                              torch.from_numpy(ls), s, s, slice_qp, bd, True,
                              k)
    np.testing.assert_array_equal(mk, mr.numpy())
    np.testing.assert_allclose(ck, cr.numpy(), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# K5: the pooled plane, strips of blocks, uint32 row partials
# ---------------------------------------------------------------------------

def _k5_model(sp, rp, W, H, R):
    """K5's data flow on int16 padded planes (numpy) -> (mv [N, 2] int32,
    cost [N] float32): strips of 4 blocks sharing one pooled window
    (offset 4 per block), each pooled row's four squared differences
    summed in uint32 and the rows in uint64, the (cost, index) minimum;
    stage 2's SSEs in int32."""
    from numpy.lib.stride_tricks import sliding_window_view as windows
    pad, bs, q, strip = 96, 16, 4, 4
    Hp, Wp = rp.shape
    pool = rp.astype(np.int32).reshape(Hp // q, q, Wp // q, q).sum(
        axis=(1, 3), dtype=np.int32)
    nx, ny = W // bs, H // bs
    Rq = R // q
    span, D = 2 * Rq + bs // q, 2 * Rq + 1
    mv = np.zeros((ny * nx, 2), np.int32)
    cost = np.zeros(ny * nx, np.float32)
    for by in range(ny):
        for bx0 in range(0, nx, strip):
            nb = min(strip, nx - bx0)
            wy0, wx0 = by * 4 + pad // q - Rq, bx0 * 4 + pad // q - Rq
            win = pool[wy0:wy0 + span, wx0:wx0 + span + 4 * (nb - 1)]
            for jb in range(nb):
                r0, c0 = pad + by * bs, pad + (bx0 + jb) * bs
                blk = sp[r0:r0 + bs, c0:c0 + bs].astype(np.int32)
                qb = blk.reshape(4, q, 4, q).sum(axis=(1, 3), dtype=np.int32)
                e = windows(win[:, 4 * jb:4 * jb + span], (4, 4)) - qb
                part = (e * e).astype(np.uint32).sum(axis=-1, dtype=np.uint32)
                acc = part.astype(np.uint64).sum(axis=-1, dtype=np.uint64)
                c1 = int(np.argmin(acc.ravel()))       # the first minimum
                cy, cx = c1 // D - Rq, c1 % D - Rq
                y2, x2 = r0 + 4 * cy - 3, c0 + 4 * cx - 3
                e2 = windows(rp[y2:y2 + 22, x2:x2 + 22].astype(np.int32),
                             (bs, bs)) - blk
                s2 = (e2 * e2).sum(axis=(-2, -1), dtype=np.int32)
                c2 = int(np.argmin(s2.ravel()))
                b = by * nx + bx0 + jb
                mv[b] = (4 * cx + c2 % 7 - 3, 4 * cy + c2 // 7 - 3)
                cost[b] = np.float32(s2.ravel()[c2])
    return mv, cost


def test_k5_partials_are_exact_for_samples_of_11_bits():
    """A pooled row's four squared differences fit uint32 for samples of
    up to 11 bits (4 (16 * 2047)^2 < 2^32) and wrap at 12; stage 2's
    256 differences fit int32 (256 * 2047^2 < 2^31)."""
    for bits, exact in ((11, True), (12, False)):
        e = np.full(4, 16 * ((1 << bits) - 1), np.int64)
        wrapped = (e * e).astype(np.uint32).sum(dtype=np.uint32)
        assert (int(wrapped) == int((e * e).sum())) == exact
    assert 256 * 2047 ** 2 < 2 ** 31


def _me_planes(kind, W, H, rng):
    """(src, ref) sample planes of a K5 case."""
    top = 2047
    if kind == "random":
        base = rng.randint(0, 1024, (H + 40, W + 40))
        return base[10:10 + H, 12:12 + W], base[13:13 + H, 7:7 + W]
    if kind == "flat":                       # every candidate ties
        return np.full((H, W), 700), np.full((H, W), 300)
    if kind == "max_vs_zero":                # every difference extreme
        return np.full((H, W), top), np.zeros((H, W), np.int64)
    yy, xx = np.mgrid[:H, :W]
    cell = 4 if kind == "pooled_checker" else 1
    c = np.where((yy // cell + xx // cell) % 2 == 0, top, 0)
    return c, top - c


@pytest.mark.parametrize("kind", ["random", "flat", "max_vs_zero",
                                  "pooled_checker", "checker"])
@pytest.mark.parametrize("R", [0, 4, 16, 64])
def test_k5_model_equals_the_plain_version(R, kind):
    """K5's data flow gives frame_me_ref's MVs and costs on a width of 5
    blocks (a strip of 4 and a strip of 1), on flat planes (ties: the
    lowest index wins) and at the 0 / 2047 extremes."""
    from vvenc_tpu_torch.ops import me as M
    W, H = 80, 48
    src, ref = _me_planes(kind, W, H, np.random.RandomState(R))
    sp, rp = (np.pad(a, M.ME_PAD, mode="edge").astype(np.int16)
              for a in (src, ref))
    mk, ck = _k5_model(sp, rp, W, H, R)
    mr, cr = M.frame_me_ref(torch.from_numpy(sp), torch.from_numpy(rp), W, H,
                            R)
    np.testing.assert_array_equal(mk, mr.numpy())
    np.testing.assert_array_equal(ck, cr.numpy())


# ---------------------------------------------------------------------------
# K11: the float32 route (bit depths <= 10) in the mode's own orientation
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """__fmaf_rn on float32 values: exact in float64 here, rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _k11_model(src, rm, tops, lefts, w, bd):
    """K11's float32 route (numpy float32, each operation rounded as the
    kernel's) -> costs [B, 67] int64: an angular mode's residual in its
    own orientation (the transposed source for a horizontal mode), the
    4-tap sum as fmas from 0.5, the round as one fma onto 1.5 * 2^23, the
    clip on that value, the tile Hadamard in float32 with its last column
    stage fused into the abs-sum; planar and DC in integers."""
    from vvenc_tpu_torch.ops import intra_batch as IB
    _, _, row_start, filt, transposed, _ = IB._mode_tables(w, w)
    T = 8 if w % 8 == 0 else 4
    B = len(src)
    src_m = src.astype(np.float32) + MAGIC
    vmax = MAGIC + np.float32((1 << bd) - 1)
    lw = w.bit_length() - 1
    t64, l64 = tops.astype(np.int64), lefts.astype(np.int64)
    out = np.zeros((B, 67), np.int64)
    for m in range(67):
        if m >= 2:
            sp = src_m.transpose(0, 2, 1) if transposed[m] else src_m
            idx = row_start[m][:, None] + np.arange(w)[None, :]
            acc = np.full((B, w, w), 0.5, np.float32)
            for k in range(4):
                acc = _fma32(rm[:, m][:, idx + k].astype(np.float32),
                             filt[m][None, :, k, None].astype(np.float32), acc)
            y = np.clip(_fma32(acc, np.float32(1 / 64), MAGIC), MAGIC, vmax)
            d = sp - y
        else:
            yy, xx = np.mgrid[:w, :w]
            if m == 0:
                lc, tp = l64[:, 1:w + 1, None], t64[:, None, 1:w + 1]
                trr, br = t64[:, 1 + w, None, None], l64[:, 1 + w, None, None]
                hor = (lc << lw) + (xx + 1) * (trr - lc)
                ver = (tp << lw) + (yy + 1) * (br - tp)
                p = ((hor << lw) + (ver << lw) + (1 << 2 * lw)) >> (1 + 2 * lw)
            else:
                s = w + t64[:, 1:w + 1].sum(1) + l64[:, 1:w + 1].sum(1)
                p = np.broadcast_to((s >> (lw + 1))[:, None, None], (B, w, w))
            d = src_m - (p.astype(np.float32) + MAGIC)
        t = d.reshape(B, w // T, T, w // T, T).transpose(0, 1, 3, 2, 4)
        # rows, then the columns' stages but the last, which fuses with
        # the abs-sum: |a + c| + |a - c| = 2 max(|a|, |c|)
        t = _wht_rows(_wht_rows(t).swapaxes(-1, -2), last=T // 2)
        a, c = t[..., :T // 2], t[..., T // 2:]
        s = 2 * np.maximum(np.abs(a), np.abs(c)).reshape(
            t.shape[:3] + (T * T // 2,)).sum(-1, dtype=np.float32) \
            .astype(np.int64)
        if T == 8:
            v = (s + 2) >> 2
        else:
            dc = np.abs(a[..., 0, 0] + c[..., 0, 0]).astype(np.int64)
            v = (s - dc + (dc >> 2) + 1) >> 1
        out[:, m] = v.sum(axis=(1, 2))
    return out


def _mode_inputs(kind, B, w, bd, rng):
    top = (1 << bd) - 1
    tops = rng.randint(0, top + 1, (B, 2 * w + 3)).astype(np.int32)
    lefts = rng.randint(0, top + 1, (B, 2 * w + 3)).astype(np.int32)
    src = rng.randint(0, top + 1, (B, w, w)).astype(np.int32)
    if kind == "max_src":                    # residuals at +max
        src[:], tops[:], lefts[:] = top, 0, 0
    elif kind == "zero_src":                 # residuals at -max
        src[:], tops[:], lefts[:] = 0, top, top
    elif kind == "checker":                  # taps of both signs at max
        src[:] = np.where(np.indices((w, w)).sum(0) % 2 == 0, top, 0)
        tops[:] = np.where(np.arange(2 * w + 3) % 2 == 0, top, 0)
        lefts[:] = top - tops
    lefts[:, 0] = tops[:, 0]
    return src, tops, lefts


@pytest.mark.parametrize("kind", ["random", "max_src", "zero_src",
                                  "checker"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
def test_k11_float_route_equals_the_plain_version(w, bd, kind):
    """K11's float32 route gives mode_costs_batch_ref's int32 costs on
    random samples and at the 0 / max extremes, every size, 8 and 10
    bits (every float32 value an integer below 2^24)."""
    from vvenc_tpu_torch.ops import intra_batch as IB
    B = 4 if w <= 16 else 2
    src, tops, lefts = _mode_inputs(kind, B, w, bd,
                                    np.random.RandomState(w + bd))
    rm = IB.build_ref_mains(tops, lefts, w, w)
    want = IB.mode_costs_batch_ref(*(torch.from_numpy(a) for a in
                                     (src, rm, tops, lefts)), w, w, bd)
    np.testing.assert_array_equal(_k11_model(src, rm, tops, lefts, w, bd),
                                  want.numpy())


# ---------------------------------------------------------------------------
# K6: split-int8 stages of 16 points and more, the integer pipe below, the
# integer route for inputs outside [-2^15, 2^15)
# ---------------------------------------------------------------------------

def _wrap_shift(acc, shift):
    """clip((acc + 2^(shift-1)) >> shift) with acc and the rounding add
    wrapped to int32, as the reference's XLA int32 arithmetic."""
    v = (np.asarray(acc, np.int64) + (1 << (shift - 1))) & 0xFFFFFFFF
    v = np.where(v >= 1 << 31, v - (1 << 32), v)
    return np.clip(v >> shift, -(1 << 15), (1 << 15) - 1)


def _k6_model(x, w, h, bd, fwd):
    """K6's data flow on x [B, h, w]: each stage of 16 points or more
    through _split_product (which asserts every int32 partial), the 4- and
    8-point stages and the integer route (a block's input outside
    [-2^15, 2^15) when stage 1 is on the tensor cores) in int64 wrapped
    to int32; the forward 64-point zero-out computes only the kept
    32x32 corner."""
    from vvenc_tpu_torch.ops import transforms as TR
    tw = TR.tr_matrix(w, TR.DCT2).astype(np.int64)
    th = TR.tr_matrix(h, TR.DCT2).astype(np.int64)
    k1, k2 = (w, h) if fwd else (h, w)
    s1 = (w.bit_length() - 1) + bd - 9 if fwd else 7
    s2 = (h.bit_length() - 1) + 6 if fwd else 20 - bd
    out = np.zeros(x.shape, np.int64)
    for b, X in enumerate(np.asarray(x, np.int64)):
        wide = k1 >= 16 and (X.min() < -(1 << 15) or X.max() >= 1 << 15)

        def prod(T, D, k):
            return T @ D if wide or k < 16 else _split_product(T, D)
        if fwd:
            tmp = _wrap_shift(prod(tw, X.T, k1).T, s1)       # [y][u]
            kv, ku = (min(h, 32), min(w, 32)) if w > 32 or h > 32 \
                else (h, w)
            out[b, :kv, :ku] = _wrap_shift(
                prod(th[:kv], tmp[:, :ku], k2), s2)
        else:
            tmp = _wrap_shift(prod(th.T, X, k1), s1)         # [y][u]
            out[b] = _wrap_shift(prod(tw.T, tmp.T, k2).T, s2)
    return out.astype(np.int32)


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("h", [4, 8, 16, 32, 64])
def test_k6_split_stages_equal_the_plain_version(w, h):
    """Both directions of every (w, h) pair, rectangular classes and the
    64-point zero-out included: residuals at +-(2^bd - 1) (8 and 10
    bits), coefficients at -2^15 and 2^15 - 1 (the split's extremes), and
    a block past 2^15 (the integer route, wrapping) beside in-range ones;
    equal to fwd/inv_transform_batch_ref."""
    from vvenc_tpu_torch.ops import transforms as TR
    rng = np.random.RandomState(w * 64 + h)
    cases = []
    for bd in (8, 10):
        top = (1 << bd) - 1
        x = rng.randint(-top, top + 1, (3, h, w))
        x[0] = np.where(np.indices((h, w)).sum(0) % 2 == 0, top, -top)
        cases.append((x, bd))
    c = rng.choice([-(1 << 15), (1 << 15) - 1], (3, h, w))
    c[1] = rng.choice([-(1 << 20), 1 << 30, 1 << 15], (h, w))
    cases.append((c, 10))
    for x, bd in cases:
        x = x.astype(np.int32)
        t = torch.from_numpy(x)
        np.testing.assert_array_equal(
            _k6_model(x, w, h, bd, True),
            TR.fwd_transform_batch_ref(t, w, h, bd).numpy())
        np.testing.assert_array_equal(
            _k6_model(x, w, h, bd, False),
            TR.inv_transform_batch_ref(t, w, h, bd).numpy())


# ---------------------------------------------------------------------------
# K9: the float32 route's correlation, box sums and uint32 combination
# ---------------------------------------------------------------------------

K9_SPAN = 1023            # full_search.cu kSpan
K9_MAGIC_BITS = 0x4B000000


def _k9_float_route(block, area):
    """K9's route test: the float route takes samples in [0, K9_SPAN]."""
    return min(block.min(), area.min()) >= 0 and \
        max(block.max(), area.max()) <= K9_SPAN


def _k9_model(block, area):
    """K9's float32 route on one block [h, w] and its area [ah, aw]
    (samples in [0, K9_SPAN]) -> the uint32 SSE of every displacement:
    per area row and chunk of CH = 8 columns (4 when 8 does not divide w)
    the window sum of a^2 and the partial correlation, each started at
    2^23 and taken as a float32 bit pattern; u sums bits(a^2) - 2
    bits(correlation) in uint32, and SSE = u + chunks * bits(2^23) +
    sum(b^2) mod 2^32."""
    assert _k9_float_route(block, area)
    a, b = area.astype(np.int64), block.astype(np.int64)
    h, w = b.shape
    ch = 8 if w % 8 == 0 else 4
    win = np.lib.stride_tricks.sliding_window_view(a, (h, w))  # [gh,gw,h,w]

    def bits(part):
        assert part.max() < 1 << 23
        f = (part + (1 << 23)).astype(np.float32)
        assert np.array_equal(f.astype(np.int64), part + (1 << 23))  # exact
        return f.view(np.uint32).astype(np.int64)
    shape = win.shape[:3] + (w // ch, ch)
    corr = bits((win * b).reshape(shape).sum(-1))
    sq = bits((win * win).reshape(shape).sum(-1))
    u = (sq - 2 * corr).sum(axis=(2, 3))
    nchunks = h * (w // ch)
    bsq = int((b * b).sum())
    return (u + nchunks * K9_MAGIC_BITS + bsq) % (1 << 32)


@pytest.mark.parametrize("h,w,ah,aw,kind", [
    (64, 64, 66, 66, "checker"), (64, 64, 70, 68, "random"),
    (16, 16, 48, 48, "random"), (16, 16, 48, 48, "checker"),
    (8, 8, 24, 24, "random"), (4, 4, 12, 12, "checker"),
    (12, 20, 19, 41, "random"), (8, 16, 8, 80, "max_vs_zero")])
def test_k9_float_route_equals_the_int64_sse(h, w, ah, aw, kind):
    """The float route's SSEs equal the direct int64 SSE
    (full_search_sse_np) and, rounded to float32, the plain version's:
    0 / 1023 checkerboards (the largest SSE: 64x64 at 4096 * 1023^2, just
    below 2^32), random 10-bit data, rectangular areas, w = 20 (partials
    of 4), and a block at 1023 over an area of 0."""
    from vvenc_tpu_torch.ops import me as M
    rng = np.random.RandomState(h * 3 + w + ah)
    if kind == "checker":
        block = np.where(np.indices((h, w)).sum(0) % 2 == 0, K9_SPAN, 0)
        area = np.where(np.indices((ah, aw)).sum(0) % 2 == 0, 0, K9_SPAN)
    else:
        block = rng.randint(0, K9_SPAN + 1, (h, w))
        area = rng.randint(0, K9_SPAN + 1, (ah, aw))
        if kind == "max_vs_zero":
            block, area = np.full_like(block, K9_SPAN), np.zeros_like(area)
    block, area = block.astype(np.int32), area.astype(np.int32)
    want = M.full_search_sse_np(block, area)
    np.testing.assert_array_equal(_k9_model(block, area), want)
    ref = M.full_search_sse_batch_ref(torch.from_numpy(block[None]),
                                      torch.from_numpy(area[None]), h, w)
    np.testing.assert_array_equal(want.astype(np.float32), ref[0].numpy())


def test_k9_range_threshold_and_partial_bits():
    """1023 is the largest sample the float route takes: 8 products stay
    below 2^23 and a 64x64 SSE below 2^32 only up to it (at 1024 the
    partial reaches 2^23 and the checkerboard's SSE wraps to 0 in
    uint32), so 1024 and negative samples take the integer route; a
    partial p < 2^23 started at 2^23 is the float32 whose bit pattern is
    0x4B000000 + p."""
    z = np.zeros((4, 4), np.int64)
    assert _k9_float_route(z + K9_SPAN, z)
    assert not _k9_float_route(z + K9_SPAN + 1, z)
    assert not _k9_float_route(z, z - 1)
    assert 8 * K9_SPAN ** 2 < 1 << 23 <= 8 * (K9_SPAN + 1) ** 2
    assert 4096 * K9_SPAN ** 2 < 1 << 32 <= 4096 * (K9_SPAN + 1) ** 2
    assert (4096 * (K9_SPAN + 1) ** 2) % (1 << 32) == 0
    p = np.array([0, 1, 8 * K9_SPAN ** 2, (1 << 23) - 1], np.int64)
    f = (p + (1 << 23)).astype(np.float32)
    np.testing.assert_array_equal(f.view(np.uint32).astype(np.int64),
                                  K9_MAGIC_BITS + p)


def _k9_integer_route(block, area):
    """K9's integer route on one block [h, w] and its area: per sample
    |a - b| as uint32 (__sad of two int32), squared and added by one
    32 x 32 -> 64-bit multiply-add into a uint64 sum (mod 2^64), read back
    as int64."""
    a = area.astype(np.int64)
    b = block.astype(np.int64)
    win = np.lib.stride_tricks.sliding_window_view(a, b.shape)
    # sad.s32: (a < b ? b - a : a - b) in 32-bit unsigned arithmetic
    d = np.where(win < b, b - win, win - b) % (1 << 32)
    assert np.array_equal(d, np.abs(win - b))  # exact: |a - b| < 2^32
    sq = d.astype(np.uint64) * d.astype(np.uint64)      # mod 2^64
    return sq.sum(axis=(2, 3), dtype=np.uint64).view(np.int64)


@pytest.mark.parametrize("lo,hi", [(0, 4095), (0, 65535), (-1, 0),
                                   (-(1 << 31), (1 << 31) - 1),
                                   (-(1 << 20), 1 << 20)])
def test_k9_integer_route_equals_the_int64_sse(lo, hi):
    """The integer route's sums have the bits of the int64 sum of (a -
    b)^2 that the plain version takes, for int32 samples anywhere in
    [lo, hi]: 0 / max checkerboards (12 and 16 bits), -1 / 0, the int32
    extremes (each square near 2^64, the sums wrapping as int64 does) and
    random data past 2^20."""
    from vvenc_tpu_torch.ops import me as M
    h, w, ah, aw = 6, 10, 13, 19
    rng = np.random.RandomState(hi % 1000 + 7)
    if hi - lo < (1 << 21):
        block = np.where(np.indices((h, w)).sum(0) % 2 == 0, hi, lo)
        area = np.where(np.indices((ah, aw)).sum(0) % 2 == 0, lo, hi)
    else:
        block = rng.choice([lo, hi, 0, -1, 1], (h, w))
        area = rng.choice([lo, hi, 0, -1, 1], (ah, aw))
    block, area = block.astype(np.int32), area.astype(np.int32)
    got = _k9_integer_route(block, area)
    d = (np.lib.stride_tricks.sliding_window_view(
        area.astype(np.int64), (h, w)) - block.astype(np.int64))
    with np.errstate(over="ignore"):
        want = (d * d).sum(axis=(2, 3))        # int64, wrapping
    np.testing.assert_array_equal(got, want)
    ref = M.full_search_sse_batch_ref(torch.from_numpy(block[None]),
                                      torch.from_numpy(area[None]), h, w)
    np.testing.assert_array_equal(got.astype(np.float32), ref[0].numpy())
