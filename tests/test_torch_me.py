"""The port's frame-level device ME against the JAX package's: the plain
version of frame_me (what kernel K5 computes) gives the same MVs as
vvenc_tpu.ops.me.frame_me on pictures with a known shift.  The port's
SSEs are exact integers and the reference's are float32 sums, so an MV
may differ only at a near tie of the reference's costs (relative gap
< 1e-6); the test clips have none, and the count is asserted to be 0.
Costs agree within rtol 1e-6 (the reference's float32 sum order)."""

import numpy as np
import pytest
import torch

import vvenc_tpu.ops.me as JM
import vvenc_tpu_torch.ops.me as TM

TIE_RTOL = 1e-6


def _pictures(W, H, shift, seed):
    import scipy.ndimage as ndi
    rng = np.random.RandomState(seed)
    base = ndi.gaussian_filter(
        rng.uniform(0, 1023, (H + 80, W + 80)), 2.0)
    base = (base - base.min()) / (base.max() - base.min()) * 900 + 50
    base = (base + rng.randint(-8, 9, base.shape)).astype(np.int32)
    dx, dy = shift
    src = base[40:40 + H, 40:40 + W]
    ref = base[40 + dy:40 + dy + H, 40 + dx:40 + dx + W]
    return src, ref


def _pad(a):
    return np.pad(a, TM.ME_PAD, mode="edge").astype(np.int16)


def _near_tie_flips(sp, rp, W, H, R, mv_j, mv_t):
    """Blocks whose MVs differ; each must be a near tie of the reference's
    own stage-2 float32 costs (recomputed here in float64)."""
    flips = np.nonzero((mv_j != mv_t).any(axis=1))[0]
    nx = W // TM.ME_BS
    for b in flips:
        by, bx = divmod(int(b), nx)
        y0, x0 = TM.ME_PAD + by * 16, TM.ME_PAD + bx * 16
        blk = sp[y0:y0 + 16, x0:x0 + 16].astype(np.float64)

        def sse(mv):
            ys, xs = y0 + int(mv[1]), x0 + int(mv[0])
            return ((rp[ys:ys + 16, xs:xs + 16] - blk) ** 2).sum()
        a, c = sse(mv_j[b]), sse(mv_t[b])
        assert abs(a - c) <= TIE_RTOL * max(a, c, 1.0), (b, a, c)
    return len(flips)


@pytest.mark.parametrize("R", [16, 64])
@pytest.mark.parametrize("shift", [(5, -3), (-11, 7)])
def test_frame_me_mvs_equal_jax(R, shift):
    W = H = 128
    src, ref = _pictures(W, H, shift, seed=R + shift[0])
    sp, rp = _pad(src), _pad(ref)
    mv_j, cost_j = (np.asarray(a) for a in JM.frame_me(sp, rp, W, H, R))
    mv_t, cost_t = TM.frame_me(torch.from_numpy(sp), torch.from_numpy(rp),
                               W, H, R)
    assert mv_t.dtype == torch.int32 and mv_t.shape == (64, 2)
    assert cost_t.dtype == torch.float32 and cost_t.shape == (64,)
    mv_t, cost_t = mv_t.numpy(), cost_t.numpy()
    flips = _near_tie_flips(sp, rp, W, H, R, mv_j, mv_t)
    print(f"R={R} shift={shift}: {flips} near-tie flips")
    assert flips == 0
    np.testing.assert_allclose(cost_t, cost_j, rtol=TIE_RTOL, atol=0)
    # interior blocks find the known shift (the edge blocks see padding):
    # src(x, y) = ref(x - dx, y - dy)
    inner = mv_t.reshape(8, 8, 2)[2:6, 2:6].reshape(-1, 2)
    assert (inner == -np.array(shift)).all(axis=1).mean() > 0.9


def test_frame_me_exact_sse_against_numpy_full_search():
    """Stage 2's cost is the exact SSE at the returned MV."""
    W, H = 64, 48
    src, ref = _pictures(W, H, (3, 2), seed=5)
    sp, rp = _pad(src), _pad(ref)
    mv, cost = TM.frame_me_ref(torch.from_numpy(sp), torch.from_numpy(rp),
                               W, H, 16)
    for b in range(mv.shape[0]):
        by, bx = divmod(b, W // 16)
        y0, x0 = TM.ME_PAD + by * 16, TM.ME_PAD + bx * 16
        mx, my = (int(v) for v in mv[b])
        area = rp[y0 + my - 1:y0 + my + 17, x0 + mx - 1:x0 + mx + 17]
        sse = TM.full_search_sse_np(sp[y0:y0 + 16, x0:x0 + 16]
                                    .astype(np.int64), area)
        assert sse[1, 1] == int(cost[b])
        assert sse[1, 1] == sse.min()     # a +-1 local minimum


def test_frame_me_table_lookup_equal_jax():
    """FrameMe on a picture that is not a multiple of 16 (the table
    covers the block multiple; lookups clamp)."""
    src, ref = _pictures(120, 72, (4, -2), seed=9)
    tj = JM.FrameMe(src, ref, R=32)
    tt = TM.FrameMe(src, ref, R=32, device="cpu")
    assert tt.mv.shape == tj.mv.shape == (4, 7, 2)
    np.testing.assert_array_equal(tt.mv, tj.mv)
    for x, y in [(0, 0), (119, 71), (-5, 200), (60, 30), (112, 64)]:
        assert tt.lookup(x, y) == tj.lookup(x, y)


def test_frame_me_refuses_what_it_does_not_take():
    sp = torch.zeros((64 + 192, 64 + 192), dtype=torch.int16)
    with pytest.raises(ValueError):
        TM.frame_me(sp, sp, 48, 64, 16)          # planes do not match
    with pytest.raises(ValueError):
        TM.frame_me(sp, sp, 64, 64, 65)          # range above 64
    with pytest.raises(ValueError):
        TM.frame_me(sp.to("meta"), sp.to("meta"), 64, 64, 16)


def test_device_me_raises_instead_of_falling_back(monkeypatch):
    """A FrameMe failure reaches the caller: the searcher no longer hands
    the block to the host search."""
    from vvenc_tpu_torch.encoder.inter_search import InterSearchMixin

    class Searcher(InterSearchMixin):
        pass

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(TM, "frame_me", broken)
    s = Searcher()
    s.cfg = type("Cfg", (), dict(search_range=64, device="cpu"))()
    s.src_me_y = np.zeros((32, 32), np.int32)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        s._device_me(np.zeros((32, 32), np.int32))


def test_launch_counts_and_device_clock_under_threads():
    """Wrappers count launches, and PROF records the device sections,
    from the encoder's worker threads: no count and no record is lost,
    and each section's record names its own thread and covers its wall
    time (the device sections are PROF spans since the always-on device
    clock was retired)."""
    import sys
    import threading
    import time

    from vvenc_tpu_torch.ops import kernels
    from vvenc_tpu_torch.utils.profiler import Profiler
    prof = Profiler(True)
    before = kernels.launches["frame_me"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(16)
    try:
        def work():
            with prof.section("device.frame_me"):
                for _ in range(2000):
                    kernels.count("frame_me")
                barrier.wait(timeout=30)   # all 16 sections open at once
                time.sleep(0.05)
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert kernels.launches["frame_me"] == before + 16 * 2000
    recs = prof.records()
    assert len(recs) == 16 and prof._acc["device.frame_me"][1] == 16
    assert {r.thread for r in recs} == {t.ident for t in ts}
    assert all(r.parent is None and r.end_ns - r.start_ns >= 0.05e9
               for r in recs)
