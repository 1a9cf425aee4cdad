"""The data flow of K1 intra_pred_all and K2 satd_modes as the kernels on
the card run it (csrc/intra_pred_all.cu, csrc/satd_modes.cu), held in
numpy against the JAX reference (vvenc_tpu/ops/intra_presel.py
predict_all_modes and satd_batch).  A CUDA kernel has no CPU mode, so
these models are what the CPU can check of the kernels' arithmetic;
tests/test_torch_kernels.py holds the kernels themselves on the card.

K1 gathers each mode's reference main (its row of rm_flat) from the
pool's int16 values as float32, reads a run of R samples' windows from
it, and sums the 4 taps on the float32 pipe: (acc + rnd) >> shift is one
fused multiply-add of acc + rnd - 2^(shift-1) + 0.5 by 2^-shift onto
1.5 * 2^23, whose float bits hold the clipped sample in their low 16
bits; PDPC likewise.  A float64 value that is exact, cast to float32, is
the fused multiply-add's single rounding.

K2 stages the source as one word a sample (even samples the value, odd
ones value << 16 | 0xFFFF), so that int16(src) - pred is one 32-bit
subtraction from the packed prediction pair and one sign extension, and
fuses the last column stage of the Hadamard with the absolute sum:
|a + c| + |a - c| = 2 max(|a|, |c|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vvenc_tpu.ops.intra_presel as JP
from vvenc_tpu.ops.intra_vec import _shape_tables as ref_shape_tables
from vvenc_tpu_torch.ops.tables import (FLAG_ANG0, FLAG_PDPC, FLAG_VER,
                                        PDPC_COLS, _angular_tables)

MAGIC = 1.5 * 2 ** 23
SIDES = (4, 8, 16, 32, 64)
ALL_CLASSES = [(w, h) for w in SIDES for h in SIDES]

_predict = jax.jit(JP.predict_all_modes, static_argnums=(2, 3, 4))
_satd = jax.jit(JP.satd_batch, static_argnums=(2, 3))


def _f32(x):
    """A float64 value rounded once to float32 (exact inputs: the single
    rounding of a fused multiply-add)."""
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("w,h", ALL_CLASSES)
def test_k1_tables_hold_what_the_kernel_assumes(w, h):
    """The tables K1 reads (ops/tables._angular_tables, uploaded by
    device_tables) are the reference's _shape_tables, and hold what the
    kernel relies on: 16-byte rows of 4-column loads (TM a multiple of 4),
    LR = 3 TM + 12 (the resource query's length), every window inside
    its main, every pool position inside the 4 * LPAD pool, PDPC weights
    only in the first PDPC_COLS columns, sum |taps| < 128 (a 4-tap sum of
    int16 values stays below 2^22, exact on the float32 pipe) and a shift
    of at least 1 (the round by one fused multiply-add)."""
    t = ref_shape_tables(w, h, True, 0)
    a = _angular_tables(w, h)
    TM, LR, LPAD = a["TM"], a["LR"], a["LPAD"]
    assert (LPAD, LR, TM, a["B0"]) == (t.LPAD, t.LR, max(w, h), t.B0)
    assert np.array_equal(a["rm_flat"], t.rm_src.astype(np.int64) * LPAD
                          + t.rm_idx)
    assert np.array_equal(a["row_start"], t.row_start)
    assert np.array_equal(a["filt"], t.filt)
    assert np.array_equal(a["mode_info"][:, :2],
                          np.stack([t.shift, t.round], 1))
    assert np.array_equal(a["mode_info"][:, 2] & FLAG_VER, t.is_ver * 1)
    assert np.array_equal(a["pdpc_wl"], t.pdpc_wl)
    assert TM % 4 == 0 and LR == 3 * TM + 12
    assert (t.shift >= 1).all()
    assert (np.abs(t.filt).sum(axis=2) < 128).all()
    assert not t.pdpc_wl[:, PDPC_COLS:].any()
    pool = 4 * LPAD
    assert 0 <= a["rm_flat"].min() and a["rm_flat"].max() < pool
    for m in range(65):
        rows, cols = (h, w) if t.is_ver[m] else (w, h)
        assert a["row_start"][m, :rows].max() + cols + 3 <= LR
        live = a["pdpc_wl"][m, :cols] != 0
        side = a["side_flat"][m, :rows, :cols][:, live]
        assert side.size == 0 or (0 <= side.min() and side.max() < pool)


def _pool(tops, lefts, w, h, lpad):
    """intra_pred.cuh's pool [top | ftop | left | fleft] (int64) of each
    block: the raw references and their [1 2 1] filtered copies."""
    top = tops[:, :lpad].astype(np.int64)
    left = lefts[:, :lpad].astype(np.int64)
    corner = (top[:, 0] + top[:, 1] + left[:, 0] + left[:, 1] + 2) >> 2

    def filt(x, n):
        f = np.repeat(x[:, n:n + 1], lpad, axis=1)
        f[:, 0] = corner
        f[:, 1:n] = (x[:, :n - 1] + 2 * x[:, 1:n] + x[:, 2:n + 1] + 2) >> 2
        return f
    return np.concatenate([top, filt(top, 2 * w), left, filt(left, 2 * h)],
                          axis=1)


def _planar_dc(pool, lpad, w, h, bd, mode):
    """intra_pred.cuh planar_dc_sample for every (y, x): [B, h, w]."""
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    mdis = mode == 0 and w * h > 32
    ptop = pool[:, lpad:] if mdis else pool
    pleft = pool[:, 3 * lpad:] if mdis else pool[:, 2 * lpad:]
    y = np.arange(h)[None, :, None]
    x = np.arange(w)[None, None, :]
    lc, trr = pleft[:, 1:h + 1, None], ptop[:, None, 1:w + 1]
    if mode == 0:
        tr, br = ptop[:, w + 1, None, None], pleft[:, h + 1, None, None]
        hor = lc * (1 << lw) + (x + 1) * (tr - lc)
        ver = trr * (1 << lh) + (y + 1) * (br - trr)
        v = (hor * (1 << lh) + ver * (1 << lw) + (1 << (lw + lh))) >> (
            1 + lw + lh)
    else:
        denom = 2 * w if w == h else max(w, h)
        s = 0
        if w >= h:
            s = s + pool[:, 1:w + 1].sum(axis=1)
        if w <= h:
            s = s + pool[:, 2 * lpad + 1:2 * lpad + h + 1].sum(axis=1)
        v = ((s + (denom >> 1)) >> (denom.bit_length() - 1))[:, None, None]
        v = np.broadcast_to(v, (len(pool), h, w))
    scale = ((w * h).bit_length() - 1 - 2) >> 2
    wt = 32 >> np.minimum(31, (y << 1) >> scale)
    wl = 32 >> np.minimum(31, (x << 1) >> scale)
    v = v + ((wl * (lc - v) + wt * (trr - v) + 32) >> 6)
    return np.clip(v, 0, (1 << bd) - 1)


def _k1_model(tops, lefts, w, h, bd):
    """K1's arithmetic and layout: [B, 67, h, w] int16."""
    a = _angular_tables(w, h)
    lpad, TM = a["LPAD"], a["TM"]
    R = min(16, w, h)
    pool = _pool(tops, lefts, w, h, lpad)
    poolf = pool.astype(np.int16).astype(np.float64)
    vmax = MAGIC + (1 << bd) - 1
    B = len(tops)
    out = np.empty((B, 67, h, w), np.int16)
    for mode in (0, 1):
        out[:, mode] = _planar_dc(pool, lpad, w, h, bd, mode)
    j = np.arange(R)
    for mi in range(65):
        shift, rnd, flags = a["mode_info"][mi, :3]
        ver = bool(flags & FLAG_VER)
        rows, cols = (h, w) if ver else (w, h)
        main = poolf[:, a["rm_flat"][mi]]                      # [B, LR]
        acc0 = float(rnd - (1 << (shift - 1))) + 0.5
        for r in range(rows):
            rs = a["row_start"][mi, r]
            f = a["filt"][mi, r].astype(np.float64)
            for c0 in range(0, cols, R):
                x = main[:, rs + c0:rs + c0 + R + 3]
                acc = _f32(f[0] * x[:, :R] + acc0)
                for k in (1, 2, 3):
                    acc = _f32(f[k] * x[:, k:k + R] + acc)
                v = np.clip(_f32(acc * 2.0 ** -shift + MAGIC), MAGIC, vmax)
                if flags & FLAG_PDPC:
                    tl = poolf[:, a["rm_flat"][mi, a["B0"]]][:, None]
                    for jj in range(R):
                        col = c0 + jj
                        wl = a["pdpc_wl"][mi, col] if col < PDPC_COLS else 0
                        if wl == 0:
                            continue
                        lval = poolf[:, a["side_flat"][mi, r, col]]
                        base = tl[:, 0] if flags & FLAG_ANG0 \
                            else v[:, jj] - MAGIC
                        e = _f32((lval - base) * wl + 0.5)
                        d = _f32(e / 64.0 + MAGIC) - MAGIC
                        v[:, jj] = np.clip(_f32(v[:, jj] + d), MAGIC, vmax)
                # the low 16 bits of the float's bits are the sample
                bits = v.astype(np.float32).view(np.uint32) & 0xFFFF
                val = bits.astype(np.uint16).view(np.int16)
                if ver:
                    out[:, mi + 2, r, c0 + j] = val
                else:
                    out[:, mi + 2, c0 + j, r] = val
    return out


@pytest.mark.parametrize("bd", [8, 12])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 4), (16, 16), (8, 32)])
def test_k1_model_equals_the_reference(w, h, bd):
    """K1's gathered mains, windows, float32-pipe rounding, PDPC and
    store layout equal the reference's predictions bit for bit, the
    references at random values, at the rails and in a hard edge."""
    rng = np.random.RandomState(w * 64 + h + bd)
    L = ref_shape_tables(w, h, True, 0).LPAD
    B = 4
    tops = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    lefts = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    tops[0] = lefts[1] = (1 << bd) - 1
    tops[1] = lefts[0] = 0
    tops[2, :L // 2] = 0
    lefts[2, L // 2:] = (1 << bd) - 1
    ref = np.asarray(_predict(jnp.asarray(tops), jnp.asarray(lefts), w, h,
                              bd))
    assert np.array_equal(_k1_model(tops, lefts, w, h, bd), ref)


def _k2_model(src, preds, w, h):
    """K2's arithmetic: [B, M] int32 (int64 here; every value fits)."""
    T = 8 if w % 8 == 0 and h % 8 == 0 else 4
    B, M = preds.shape[:2]
    s = src.astype(np.int64).astype(np.uint32)
    words = s.copy()
    words[..., 1::2] = (s[..., 1::2] << np.uint32(16)) | np.uint32(0xFFFF)
    p = preds.view(np.uint16).astype(np.uint32)
    pair = p[..., 0::2] | (p[..., 1::2] << np.uint32(16))   # [B, M, h, w/2]
    d = np.empty((B, M, h, w), np.int64)
    lo = (words[:, None, :, 0::2] - pair) & np.uint32(0xFFFF)
    d[..., 0::2] = lo.astype(np.uint16).view(np.int16)
    hi = (words[:, None, :, 1::2] - pair).view(np.int32) >> 16
    d[..., 1::2] = hi
    t = d.reshape(B, M, h // T, T, w // T, T).transpose(0, 1, 2, 4, 3, 5)

    def stages(x, axis, upto):
        x = np.moveaxis(x, axis, -1).copy()
        ln = 1
        while ln < upto:
            for i in range(0, T, 2 * ln):
                for jj in range(i, i + ln):
                    a, c = x[..., jj].copy(), x[..., jj + ln].copy()
                    x[..., jj], x[..., jj + ln] = a + c, a - c
            ln <<= 1
        return np.moveaxis(x, -1, axis)
    t = stages(t, -1, T)                  # rows
    t = stages(t, -2, T // 2)             # columns, all but the last stage
    a, c = t[..., :T // 2, :], t[..., T // 2:, :]
    s2 = 2 * np.maximum(np.abs(a), np.abs(c)).sum(axis=(-2, -1))
    if T == 8:
        val = (s2 + 2) >> 2
    else:
        dc = np.abs(a[..., 0, 0] + c[..., 0, 0])
        val = ((s2 - dc + (dc >> 2)) + 1) >> 1
    return val.sum(axis=(2, 3))


@pytest.mark.parametrize("kind", ["random", "wrap"])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (4, 16), (16, 8)])
def test_k2_model_equals_the_reference(w, h, kind):
    """K2's source words, packed prediction pairs, butterflies and fused
    last stage equal the reference's SATD, at 4 and 8 points (the 4x4
    correction reads the DC term): on random 10-bit samples, and with
    sources and predictions at the int16 rails, where int16(src) - pred
    wraps (0 against 65535, 65535 against 0, -32768 against 32767)."""
    rng = np.random.RandomState(w * 9 + h)
    B, M = 3, 7
    if kind == "random":
        src = rng.randint(0, 1024, (B, h, w)).astype(np.int32)
        preds = rng.randint(0, 1024, (B, M, h, w)).astype(np.int16)
    else:
        src = rng.choice([0, 65535, -32768, 32767, 1023], (B, h, w)) \
            .astype(np.int32)
        preds = rng.choice([-1, 0, 32767, -32768, 1023], (B, M, h, w)) \
            .astype(np.int16)
        src[0], preds[0, 0] = 0, -1
        src[1], preds[1, 0] = 65535, 0
    ref = np.asarray(_satd(jnp.asarray(src), jnp.asarray(preds), w, h))
    assert np.array_equal(_k2_model(src, preds, w, h), ref)
