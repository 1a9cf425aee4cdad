"""The port's batched device programs of the fourth slice against the JAX
package, on the CPU (the kernels' plain versions): mc_batch (K8),
full_search_sse_batch / best_mv_batch (K9), sse/sad/satd_batch (K10) and
mode_costs_batch (K11).  Inputs come from numpy seeds and go through both
packages as numpy arrays."""

import numpy as np
import pytest
import torch

from vvenc_tpu.ops import interp as JI
from vvenc_tpu.ops import intra_batch as JB
from vvenc_tpu.ops import me as JM
from vvenc_tpu.ops import rdcost as JR
from vvenc_tpu_torch.ops import interp as IP
from vvenc_tpu_torch.ops import intra_batch as IB
from vvenc_tpu_torch.ops import kernels
from vvenc_tpu_torch.ops import me as M
from vvenc_tpu_torch.ops import rdcost as R

LUMA_PHASES = [(0, 0), (8, 0), (0, 8), (8, 8), (4, 12), (1, 15), (15, 3)]
CHROMA_PHASES = [(0, 16), (16, 0), (5, 27), (31, 31)]
MC_SHAPES = [(8, 8), (16, 4), (4, 16)]
# |port - JAX| <= FS_C * 2^-24 * (sum block^2 + sum window^2): the JAX
# costs are float32 sums of a^2, b^2 and 2ab (the correlation a
# convolution in XLA's order), which cancel; on these pictures the error
# reached 29 of these units (16x16, R = 8), so FS_C leaves a 2x margin
FS_C = 64.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth(rng, shape, bd):
    """Smooth content at bit depth bd (a blurred random field)."""
    import scipy.ndimage as ndi
    f = ndi.gaussian_filter(rng.randint(0, 255, shape).astype(np.float64), 3)
    f = (f - f.min()) / (f.max() - f.min() + 1e-9)
    return (f * 0.8 * ((1 << bd) - 1) + 0.1 * ((1 << bd) - 1)).astype(np.int32)


# ---- K8 mc_batch ------------------------------------------------------------

@pytest.mark.parametrize("luma,fx,fy",
                         [(True, fx, fy) for fx, fy in LUMA_PHASES]
                         + [(False, fx, fy) for fx, fy in CHROMA_PHASES])
def test_mc_batch_matches_jax(luma, fx, fy):
    rng = np.random.RandomState(fx * 64 + fy + 7 * luma)
    n = IP.NTAPS_LUMA if luma else IP.NTAPS_CHROMA
    for bd in (8, 10):
        for (w, h) in MC_SHAPES:
            win = rng.randint(0, 1 << bd, (5, h + n - 1, w + n - 1)) \
                .astype(np.int32)
            win[0] = (1 << bd) - 1              # the clip's upper end
            win[1] = 0
            got = IP.mc_batch(_t(win), fx, fy, w, h, bd, luma)
            want = np.asarray(JI.mc_batch(win, fx, fy, w, h, bd, luma))
            assert got.dtype == torch.int32 and tuple(got.shape) == (5, h, w)
            assert np.array_equal(got.numpy(), want), (bd, w, h)


@pytest.mark.parametrize("luma", [True, False])
def test_mc_batch_every_phase_matches_the_golden_model(luma):
    """All 256 luma / 1,024 chroma phases against the port's own
    _mc_block_py on windows cut from one plane (no JAX)."""
    rng = np.random.RandomState(3 + luma)
    bits = 4 if luma else 5
    n = IP.NTAPS_LUMA if luma else IP.NTAPS_CHROMA
    half = n // 2 - 1
    plane = rng.randint(0, 1024, (40, 40)).astype(np.int32)
    w, h = 8, 4
    pos = [(9, 11), (17, 5)]
    for fy in range(1 << bits):
        for fx in range(1 << bits):
            wins = np.stack([plane[y - half:y - half + h + n - 1,
                                   x - half:x - half + w + n - 1]
                             for x, y in pos])
            got = IP.mc_batch_ref(_t(wins), fx, fy, w, h, 10, luma).numpy()
            for k, (x, y) in enumerate(pos):
                want = IP._mc_block_py(plane, x, y, w, h, fx, fy, 10, luma)
                assert np.array_equal(got[k], want), (fx, fy, k)


def test_mc_batch_rejects_a_phase_outside_the_table():
    win = torch.zeros((1, 11, 11), dtype=torch.int32)
    with pytest.raises(IndexError):
        IP.mc_batch(win, 16, 0, 4, 4, 10, True)
    with pytest.raises(IndexError):
        # the chroma table has 33 rows (intra's phase 32), as the reference's
        IP.mc_batch(torch.zeros((1, 7, 7), dtype=torch.int32), 0, 33, 4, 4,
                    10, False)
    with pytest.raises(IndexError):
        IP.mc_batch(win, -1, 0, 4, 4, 10, True)
    with pytest.raises(ValueError):
        IP.mc_batch(win, 4, 0, 8, 8, 10, True)


# ---- K9 full_search_sse_batch / best_mv_batch -------------------------------

@pytest.mark.parametrize("s,Rg", [(8, 4), (16, 8), (16, 16)])
def test_full_search_is_exact_and_near_jax(s, Rg):
    rng = np.random.RandomState(s * 100 + Rg)
    B = 12
    plane = _smooth(rng, (B * 3 + s + 2 * Rg, 3 * s + 2 * Rg), 10)
    blocks, areas, shifts = [], [], []
    for b in range(B):
        y0 = 3 * b
        area = plane[y0:y0 + s + 2 * Rg, b % 3:b % 3 + s + 2 * Rg]
        dy, dx = rng.randint(0, 2 * Rg + 1, 2)
        blocks.append(area[dy:dy + s, dx:dx + s])
        areas.append(area)
        shifts.append((dy, dx))
    blocks = np.ascontiguousarray(np.stack(blocks))
    areas = np.ascontiguousarray(np.stack(areas))
    n0 = kernels.launches["full_search_sse"]
    got = M.full_search_sse_batch(_t(blocks), _t(areas), s, s).numpy()
    assert kernels.launches["full_search_sse"] == n0   # the CPU: no launch
    exact = np.stack([JM.full_search_sse_np(blocks[b], areas[b])
                      for b in range(B)])
    assert got.dtype == np.float32
    assert np.array_equal(got, exact.astype(np.float32))
    jx = np.asarray(JM.full_search_sse_batch(blocks, areas, s, s))
    # the tolerance of each displacement from its window's squares
    g = 2 * Rg + 1
    b2 = (blocks.astype(np.float64) ** 2).sum(axis=(1, 2))[:, None, None]
    win2 = np.stack([[[(areas[b, dy:dy + s, dx:dx + s].astype(np.float64)
                        ** 2).sum() for dx in range(g)] for dy in range(g)]
                     for b in range(B)])
    tol = FS_C * 2.0 ** -24 * (b2 + win2)
    err = np.abs(jx.astype(np.float64) - exact)
    assert (err <= tol).all(), float((err / tol).max())
    # argmins equal except at a near tie of the JAX costs
    my, mx, cost = M.best_mv_batch(_t(blocks), _t(areas), s, s)
    jy, jxx, _ = JM.best_mv_batch(blocks, areas, s, s)
    jy, jxx = np.asarray(jy), np.asarray(jxx)
    flat = jx.reshape(B, -1)
    srt = np.sort(flat, axis=1)
    near = srt[:, 1] - srt[:, 0] <= tol.reshape(B, -1).max(axis=1)
    diff = (my.numpy() != jy) | (mx.numpy() != jxx)
    assert not (diff & ~near).any()
    print(f"full_search {s}x{s} R={Rg}: max |JAX - exact| "
          f"{err.max():.1f}, {int(near.sum())} near-ties of {B}, "
          f"{int(diff.sum())} argmins differ")
    # the true shift costs 0.0 and wins
    for b, (dy, dx) in enumerate(shifts):
        assert got[b, dy, dx] == 0.0
        assert (int(my[b]), int(mx[b])) == (dy, dx)
        assert float(cost[b]) == 0.0


def test_full_search_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        M.full_search_sse_batch(torch.zeros((2, 8, 8), dtype=torch.int32),
                                torch.zeros((3, 16, 16), dtype=torch.int32),
                                8, 8)
    with pytest.raises(ValueError):
        M.full_search_sse_batch(torch.zeros((2, 8, 8), dtype=torch.int32),
                                torch.zeros((2, 6, 16), dtype=torch.int32),
                                8, 8)


# ---- K10 sse / sad / satd ---------------------------------------------------

@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("hw", [16, 64])
def test_distortions_match_jax(hw, tile):
    rng = np.random.RandomState(hw + tile)
    B = 7
    a = rng.randint(0, 1024, (B, hw, hw)).astype(np.int32)
    b = rng.randint(0, 1024, (B, hw, hw)).astype(np.int32)
    b[0] = a[0]                                 # a zero distortion
    got = R.satd_batch(_t(a), _t(b), tile)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JR.satd_batch(a, b,
                                                                tile=tile)))
    assert np.array_equal(R.sad_batch(_t(a), _t(b)).numpy(),
                          np.asarray(JR.sad_batch(a, b)))
    sse = R.sse_batch(_t(a), _t(b)).numpy()
    want = np.asarray(JR.sse_batch(a, b))
    assert sse.dtype == np.float32 and sse[0] == 0.0
    np.testing.assert_allclose(sse, want, rtol=1e-5, atol=0)
    exact = ((a.astype(np.int64) - b) ** 2).sum(axis=(1, 2))
    assert np.array_equal(sse, exact.astype(np.float32))


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_satd_large_tiles_wrap_as_jax(tile):
    """Tiles 16..64 of values large enough that the int32 sums wrap: the
    plain version wraps where XLA's int32 does."""
    rng = np.random.RandomState(tile)
    a = rng.randint(-2 ** 30, 2 ** 30, (3, 64, 64)).astype(np.int32)
    b = rng.randint(-2 ** 30, 2 ** 30, (3, 64, 64)).astype(np.int32)
    assert np.array_equal(R.satd_batch(_t(a), _t(b), tile).numpy(),
                          np.asarray(JR.satd_batch(a, b, tile=tile)))
    assert np.array_equal(R.sad_batch(_t(a), _t(b)).numpy(),
                          np.asarray(JR.sad_batch(a, b)))


def test_satd_rejects_a_tile_that_does_not_divide():
    a = torch.zeros((1, 16, 16), dtype=torch.int32)
    for tile in (3, 32, 128):
        with pytest.raises(ValueError):
            R.satd_batch(a, a, tile)


# ---- K11 mode_costs_batch ---------------------------------------------------

@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_mode_costs_match_jax(s, bd):
    rng = np.random.RandomState(s * 10 + bd)
    B = 5
    tops = rng.randint(0, 1 << bd, (B, 2 * s + 3)).astype(np.int32)
    lefts = rng.randint(0, 1 << bd, (B, 2 * s + 3)).astype(np.int32)
    lefts[:, 0] = tops[:, 0]
    tops[0] = lefts[0] = (1 << bd) - 1
    src = rng.randint(0, 1 << bd, (B, s, s)).astype(np.int32)
    rm = IB.build_ref_mains(tops, lefts, s, s)
    assert np.array_equal(rm, JB.build_ref_mains(tops, lefts, s, s))
    for a, b in zip(IB._mode_tables(s, s), JB._mode_tables(s, s)):
        assert np.array_equal(a, b)
    got = IB.mode_costs_batch(_t(src), _t(rm), _t(tops), _t(lefts), s, s, bd)
    want = np.asarray(JB.mode_costs_batch(src, rm, tops, lefts, s, s, bd))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 67)
    assert np.array_equal(got.numpy(), want)


def test_mode_costs_refuse_non_square_blocks():
    with pytest.raises(AssertionError):
        IB._mode_tables(8, 16)
    z = torch.zeros((1, 16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        IB.mode_costs_batch(z, torch.zeros((1, 67, 40), dtype=torch.int32),
                            torch.zeros((1, 19), dtype=torch.int32),
                            torch.zeros((1, 35), dtype=torch.int32), 8, 16)
