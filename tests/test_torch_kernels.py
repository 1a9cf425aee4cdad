"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes.  A CUDA kernel has no CPU mode, so without a card
these tests skip; run them where one is present with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(--noconftest: tests/conftest.py imports jax, which the port's machine
need not have).  chip_smoke.py holds the same kernels against the same
plain versions at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from vvenc_tpu_torch.ops import intra_plan as P
from vvenc_tpu_torch.ops import intra_presel as S
from vvenc_tpu_torch.ops import kernels
from vvenc_tpu_torch.ops.intra_vec import _shape_tables

SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (4, 16),
          (16, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _refs(rng, B, w, h, bd):
    L = _shape_tables(w, h, True, 0).LPAD
    tops = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    lefts = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    tops[0] = lefts[0] = (1 << bd) - 1     # clip paths
    tops[1] = lefts[1] = 0
    src = rng.randint(0, 1 << bd, (B, h, w)).astype(np.int32)
    return tops, lefts, src


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", SHAPES)
def test_intra_pred_all_and_satd_match_plain(cuda, w, h, bd):
    rng = np.random.RandomState(w * 100 + h + bd)
    tops, lefts, src = (torch.from_numpy(a).to(cuda)
                        for a in _refs(rng, 37, w, h, bd))
    n1 = kernels.launches["intra_pred_all"]
    pk = S.predict_all_modes(tops, lefts, w, h, bd)
    pr = S.predict_all_modes_ref(tops, lefts, w, h, bd)
    torch.cuda.synchronize()
    assert kernels.launches["intra_pred_all"] == n1 + 1
    assert pk.dtype == torch.int16 and pk.shape == (37, 67, h, w)
    assert torch.equal(pk, pr)
    sk = S.satd_batch(src, pk, w, h)
    sr = S.satd_batch_ref(src, pr, w, h)
    torch.cuda.synchronize()
    assert torch.equal(sk, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("mts", [True, False])
@pytest.mark.parametrize("qp", [22, 46])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_plan_trial_matches_plain(cuda, s, qp, mts):
    rng = np.random.RandomState(s + qp)
    B = 29
    tops, lefts, src = (torch.from_numpy(a).to(cuda)
                        for a in _refs(rng, B, s, s, 10))
    lm = torch.from_numpy(rng.uniform(10, 100, B).astype(np.float32))
    ls = lm.sqrt()
    lm, ls = lm.to(cuda), ls.to(cuda)
    preds = S.predict_all_modes(tops, lefts, s, s, 10)
    satd = S.satd_batch(src, preds, s, s)
    mk, ck = P.plan_trial(src, preds, satd, lm, ls, s, s, qp, 10, mts, 2)
    mr, cr = P.plan_trial_ref(src, preds, satd, lm, ls, s, s, qp, 10, mts,
                              2)
    torch.cuda.synchronize()
    assert torch.equal(mk, mr)
    # f32 sums in another order than the plain version's
    torch.testing.assert_close(ck, cr, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    tops = torch.zeros((4, 19), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        S.predict_all_modes(tops, tops, 8, 8, 10)
    src = torch.zeros((4, 8, 8), dtype=torch.int32, device=cuda)
    preds = torch.zeros((4, 67, 8, 16), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        S.satd_batch(src, preds[:, :, :, ::2], 8, 8)   # not contiguous


def _plane(rng, W, H, bd, pad):
    """A noisy edge-padded int16 source plane (the clip paths get an
    all-max and an all-zero band)."""
    src = rng.randint(0, 1 << bd, (H, W)).astype(np.int32)
    src[:8] = (1 << bd) - 1
    src[-8:] = 0
    return torch.from_numpy(np.pad(src, pad, mode="edge").astype(np.int16))


MTT_SHAPES = S.shapes_for_config(128, 2)[0]      # all 23 classes


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", MTT_SHAPES)
def test_presel_costs_matches_plain(cuda, w, h, bd):
    """K4 (fused prediction + SATD read from the plane) bit-exact against
    its plain version on the reference's gathered inputs, on every MTT
    class, rectangular misreads of the reference included."""
    rng = np.random.RandomState(w * 100 + h + bd)
    W, H, pad = 136, 72, S.FramePresel.PAD
    plane = _plane(rng, W, H, bd, pad).to(cuda)
    xs, ys, _, _ = S._class_grid(W, H, w, h, True)
    xs_d = torch.from_numpy(xs).to(cuda)
    ys_d = torch.from_numpy(ys).to(cuda)
    n = kernels.launches["presel_costs"]
    ck = S.presel_costs_plane(plane, pad, xs_d, ys_d, w, h, bd)
    cr = S.presel_costs_ref(*S.plane_inputs(plane, pad, xs, ys, w, h), w,
                            h, bd)
    torch.cuda.synchronize()
    assert kernels.launches["presel_costs"] == n + 1
    assert ck.shape == (len(xs) * len(ys), 67) and ck.dtype == torch.int32
    assert torch.equal(ck, cr)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [0, 16, 37, 64])
def test_frame_me_matches_plain(cuda, R):
    """K5 MVs equal to its plain version's (both exact in integers, ties
    to the lowest index); costs are the float32 of the same integer."""
    from vvenc_tpu_torch.ops import me as M
    rng = np.random.RandomState(R)
    W, H = 160, 96
    base = rng.randint(0, 1024, (H + 40, W + 40)).astype(np.int32)
    src = base[10:10 + H, 12:12 + W]
    ref = base[13:13 + H, 7:7 + W]
    src[:16, :16] = 500                      # flat: ties everywhere
    sp, rp = (torch.from_numpy(np.pad(a, M.ME_PAD, mode="edge")
                               .astype(np.int16)).to(cuda)
              for a in (src, ref))
    n = kernels.launches["frame_me"]
    mk, ck = M.frame_me(sp, rp, W, H, R)
    mr, cr = M.frame_me_ref(sp, rp, W, H, R)
    torch.cuda.synchronize()
    assert kernels.launches["frame_me"] == n + 1
    assert torch.equal(mk, mr)
    assert torch.equal(ck, cr)


TR_SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (16, 8),
             (32, 64), (4, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", TR_SHAPES)
def test_transform_and_quant_kernels_match_plain(cuda, w, h, bd):
    """K6 (forward and inverse DCT-2) and K7 (quant, dequant) bit-exact
    against their plain versions on the card, every QP class of the
    dequant (both shift branches) and both slice types."""
    from vvenc_tpu_torch.ops import transforms as T
    rng = np.random.RandomState(w * 100 + h + bd)
    top = (1 << bd) - 1
    resi = rng.randint(-top, top + 1, (43, h, w)).astype(np.int32)
    resi[0], resi[1] = top, -top
    resi = torch.from_numpy(resi).to(cuda)
    n = dict(kernels.launches)
    ck = T.fwd_transform_batch(resi, w, h, bd)
    cr = T.fwd_transform_batch_ref(resi, w, h, bd)
    torch.cuda.synchronize()
    assert torch.equal(ck, cr)
    rk = T.inv_transform_batch(ck, w, h, bd)
    assert torch.equal(rk, T.inv_transform_batch_ref(ck, w, h, bd))
    for qp in (0, 22, 37, 42, 51):
        for intra in (True, False):
            qk = T.quant_batch(ck, w, h, qp, bd, intra)
            assert torch.equal(qk, T.quant_batch_ref(ck, w, h, qp, bd, intra))
        qk[0, 0, 0], qk[1, 0, 0] = 40000, -40000     # the int16 clip
        assert torch.equal(T.dequant_batch(qk, w, h, qp, bd),
                           T.dequant_batch_ref(qk, w, h, qp, bd))
    torch.cuda.synchronize()
    for e, k in (("fwd_transform_batch", 1), ("inv_transform_batch", 1),
                 ("quant_batch", 10), ("dequant_batch", 5)):
        assert kernels.launches[e] == n[e] + k, e
    # K7 on a view 4 bytes off 16-byte alignment (the 4-byte path)
    x = _off(ck, 1, cuda)
    assert torch.equal(T.quant_batch(x, w, h, 37, bd),
                       T.quant_batch_ref(ck, w, h, 37, bd))
    assert torch.equal(T.dequant_batch(_off(qk, 3, cuda), w, h, 37, bd),
                       T.dequant_batch_ref(qk, w, h, 37, bd))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 1003, 4099, 1 << 21])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_quant_kernels_take_any_length_and_alignment(cuda, n, k):
    """vt_quant_batch / vt_dequant_batch on flat tensors of n samples, n
    not a multiple of 4 (the scalar tail) and above one wave's two
    vectors a thread (2^21), starting k samples past an allocation: equal
    to the plain versions, every sample written."""
    import ctypes
    from vvenc_tpu_torch.ops import transforms as T
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rng = np.random.RandomState(n + k)
    c = torch.from_numpy(rng.randint(-40000, 40000, n).astype(np.int32))
    x = _off(c.to(cuda), k, cuda)
    for name, params, argt, plain in (
            ("quant_batch", T._quant_params(16, 16, 37, 10, True),
             [P, P, L, I, I, I, P],
             lambda v: T.quant_batch_ref(v, 16, 16, 37, 10, True)),
            ("dequant_batch", T._dequant_params(16, 16, 37, 10),
             [P, P, L, I, I, P],
             lambda v: T.dequant_batch_ref(v, 16, 16, 37, 10))):
        out = torch.full((n,), -123456789, dtype=torch.int32, device=cuda)
        fn = kernels.function("quant_batch", f"vt_{name}", argt)
        kernels.check("quant_batch", fn(x.data_ptr(), out.data_ptr(), n,
                                        *params, kernels.stream_ptr(out)))
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), plain(c)), name


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", MTT_SHAPES)
def test_presel_costs_gathered_matches_plain(cuda, w, h, bd):
    """K4's gathered entry (the reference's inputs) bit-exact against
    presel_costs_ref and equal to the plane form, on every MTT class;
    and on references wider than LPAD, cut as the reference cuts them."""
    rng = np.random.RandomState(w * 10 + h + bd)
    W, H, pad = 136, 72, S.FramePresel.PAD
    plane = _plane(rng, W, H, bd, pad).to(cuda)
    xs, ys, _, _ = S._class_grid(W, H, w, h, True)
    xs_d = torch.from_numpy(xs).to(cuda)
    ys_d = torch.from_numpy(ys).to(cuda)
    inputs = S.plane_inputs(plane, pad, xs, ys, w, h)
    n = kernels.launches["presel_costs_gathered"]
    ck = S.presel_costs(*inputs, w, h, bd)
    cr = S.presel_costs_ref(*inputs, w, h, bd)
    cp = S.presel_costs_plane(plane, pad, xs_d, ys_d, w, h, bd)
    torch.cuda.synchronize()
    assert kernels.launches["presel_costs_gathered"] == n + 1
    assert torch.equal(ck, cr) and torch.equal(ck, cp)
    blocks, tops, lefts = inputs
    L = _shape_tables(w, h, True, 0).LPAD + 5
    wide_t = torch.from_numpy(rng.randint(0, 1 << bd, (len(blocks), L))
                              .astype(np.int32)).to(cuda)
    wide_l = torch.from_numpy(rng.randint(0, 1 << bd, (len(blocks), L))
                              .astype(np.int32)).to(cuda)
    assert torch.equal(S.presel_costs(blocks, wide_t, wide_l, w, h, bd),
                       S.presel_costs_ref(blocks, wide_t, wide_l, w, h, bd))


@pytest.mark.cuda
def test_mesh_of_four_positions_on_one_card(cuda):
    """Four positions on cuda:0, each on its own stream: the sharded
    programs equal the unsharded kernels, for a batch that does not
    divide and with the apron ppermute moving whole shards."""
    from vvenc_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh2d([torch.device("cuda", 0)] * 4)
    assert mesh.describe() == \
        "4 positions (gops 2 x tiles 2) on 1 card (cuda:0)"
    assert len({p.stream.cuda_stream for p in mesh.flat}) == 4
    rng = np.random.RandomState(7)
    w = h = 16
    B = 19
    src = torch.from_numpy(rng.randint(0, 1024, (B, h, w)).astype(
        np.int32)).to(cuda)
    tops, lefts = (torch.from_numpy(rng.randint(0, 1024, (B, 2 * w + 3))
                                    .astype(np.int32)).to(cuda)
                   for _ in range(2))
    costs, total = M.sharded_presel_costs(mesh, src, tops, lefts, w=w, h=h)
    ref = S.presel_costs(src, tops, lefts, w, h)
    assert torch.equal(costs, ref)
    assert int(total) == int(ref.min(dim=1).values.sum())
    lm = torch.full((B,), 30.0, device=cuda)
    m, c = M.sharded_plan_class(mesh, src, tops, lefts, lm, lm.sqrt(), w=w,
                                h=h, qp=37)
    mr, cr = P._plan_class_core(src, tops, lefts, lm, lm.sqrt(), w, h, 37)
    assert torch.equal(m, mr) and torch.equal(c, cr)
    for tl in (1, 2):
        G, Tn, b = 2, 2 * tl, 3
        n = G * Tn * b
        s2 = src[:1].expand(n, h, w).contiguous() + torch.arange(
            n, device=cuda, dtype=torch.int32)[:, None, None]
        t2, l2 = tops[:1].expand(n, -1).contiguous(), \
            lefts[:1].expand(n, -1).contiguous()

        def grid(x):
            return x.reshape((G, Tn, b) + tuple(x.shape[1:]))
        step = M.sharded_encode_step2d(mesh, w=w, h=h, qp=40)
        best, q, rec, per_gop, tot = step(grid(s2), grid(s2), grid(t2),
                                          grid(l2))
        _, _, r1, bits1, sse1 = M.search_step(s2, t2, l2, w=w, h=h, qp=40)
        nbr = torch.roll(grid(r1)[..., -1], tl, dims=1).reshape(-1, h)
        l3 = torch.cat([nbr[:, :1], nbr,
                        nbr[:, -1:].expand(-1, l2.shape[1] - h - 1)], dim=1)
        _, _, r2, bits2, sse2 = M.search_step(s2, t2, l3, w=w, h=h, qp=40)
        better = sse2 + bits2.to(torch.int64) < sse1 + bits1.to(torch.int64)
        assert torch.equal(rec, grid(torch.where(better[:, None, None], r2,
                                                 r1)))
        bits = torch.where(better, bits2, bits1)
        assert int(tot) == int(bits.sum())
        assert torch.equal(per_gop, grid(bits).sum(dim=(1, 2)))


# ---- the fourth slice: K8 mc_batch, K9 full_search_sse, K10 dist_batch,
# K11 mode_costs ---------------------------------------------------------------

# K8's phases: the 16 quarter-pel luma pairs (chip_smoke.LUMA_PHASES) and
# chroma phases 0, 1, 16 and 31 on each axis, with a few odd ones
K8_LUMA_PHASES = [(fx, fy) for fy in (0, 4, 8, 12) for fx in (0, 4, 8, 12)] \
    + [(0, 3), (1, 15), (15, 4)]
K8_CHROMA_PHASES = [(fx, fy) for fy in (0, 1, 16, 31) for fx in (0, 1, 16, 31)] \
    + [(0, 3), (31, 8)]
K8_SIZES = [(2, 2), (4, 4), (8, 4), (4, 8), (6, 6), (8, 8), (12, 8),
            (16, 16), (16, 4), (4, 16), (64, 64), (128, 128)]


def _off(t, k, device):
    """A contiguous copy of t that starts k elements past an allocation
    (4 k bytes off its 16-byte alignment for int32)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=device)
    v = buf[k:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("w,h", K8_SIZES)
def test_mc_batch_matches_plain(cuda, w, h, luma, bd):
    """Every luma (chroma) phase pair at this size and bit depth, bit-exact
    with one launch each: a batch of 37 (not a multiple of the block's
    group), B = 1, windows that start 4 bytes off 16-byte alignment
    (win[1:] of a flat buffer), and windows of int32 extremes whose sums
    wrap."""
    from vvenc_tpu_torch.ops import interp as IP
    rng = np.random.RandomState(w * 131 + h * 7 + bd + 2 * luma)
    n = IP.NTAPS_LUMA if luma else IP.NTAPS_CHROMA
    shape = (h + n - 1, w + n - 1)
    win = torch.from_numpy(rng.randint(0, 1 << bd, (37,) + shape)
                           .astype(np.int32)).to(cuda)
    win[0] = (1 << bd) - 1
    win[1] = 0
    ext = torch.from_numpy(rng.choice(
        np.array([-2 ** 31, 2 ** 31 - 1, -2 ** 30, 2 ** 30, -1, 0, 1],
                 dtype=np.int64), (5,) + shape).astype(np.int32)).to(cuda)
    cases = (win, win[:1].contiguous(), _off(win, 1, cuda), ext)
    assert cases[2].data_ptr() % 16 == 4
    for fx, fy in (K8_LUMA_PHASES if luma else K8_CHROMA_PHASES):
        for x in cases:
            c0 = kernels.launches["mc_batch"]
            got = IP.mc_batch(x, fx, fy, w, h, bd, luma)
            want = IP.mc_batch_ref(x, fx, fy, w, h, bd, luma)
            torch.cuda.synchronize()
            assert kernels.launches["mc_batch"] == c0 + 1
            assert got.shape == (x.shape[0], h, w)
            assert torch.equal(got, want), (w, h, fx, fy, x.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("s,R", [(8, 4), (16, 16), (64, 8), (32, 64)])
def test_full_search_matches_plain(cuda, s, R):
    from vvenc_tpu_torch.ops import me as M
    rng = np.random.RandomState(s + R)
    B = 21
    blocks = torch.from_numpy(rng.randint(0, 1024, (B, s, s))
                              .astype(np.int32)).to(cuda)
    areas = torch.from_numpy(rng.randint(0, 1024, (B, s + 2 * R, s + 2 * R))
                             .astype(np.int32)).to(cuda)
    areas[0, 3:3 + s, 5:5 + s] = blocks[0]
    c0 = kernels.launches["full_search_sse"]
    got = M.full_search_sse_batch(blocks, areas, s, s)
    want = M.full_search_sse_batch_ref(blocks, areas, s, s)
    torch.cuda.synchronize()
    assert kernels.launches["full_search_sse"] == c0 + 1
    assert torch.equal(got, want)
    my, mx, cost = M.best_mv_batch(blocks, areas, s, s)
    assert (int(my[0]), int(mx[0]), float(cost[0])) == (3, 5, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fx,fy", [(0, 0), (8, 0), (0, 8), (5, 11)])
def test_mc_batch_window_beyond_shared_memory(cuda, fx, fy):
    """A 256x256 luma block's 263x263 window (277 KB) does not fit a
    thread block's shared memory: the generic instantiation reads it from
    device memory, bit-exact with one launch."""
    from vvenc_tpu_torch.ops import interp as IP
    rng = np.random.RandomState(fx + 16 * fy)
    win = torch.from_numpy(rng.randint(0, 1024, (3, 263, 263))
                           .astype(np.int32)).to(cuda)
    c0 = kernels.launches["mc_batch"]
    got = IP.mc_batch(win, fx, fy, 256, 256, 10, True)
    want = IP.mc_batch_ref(win, fx, fy, 256, 256, 10, True)
    torch.cuda.synchronize()
    assert kernels.launches["mc_batch"] == c0 + 1
    assert torch.equal(got, want)


# K10's cases: (name, shape, value range); every tile that divides H and W
K10_CASES = [("13x64x64", (13, 64, 64), 0, 1024),
             ("5x64x128 wrap", (5, 64, 128), -2 ** 30, 2 ** 30),  # sums wrap
             ("7x192x320", (7, 3 * 64, 5 * 64), 0, 1024),          # 15 tiles
             ("7x24x8", (7, 24, 8), 0, 1024),            # 3 tiles at tile 8
             ("1x64x64", (1, 64, 64), 0, 4096),
             ("37x16x16", (37, 16, 16), -2 ** 30, 2 ** 30),
             # sse / sad: the 4x4 and 8x8 grids' shapes, odd widths (the
             # 4-byte path), a row of 12, a 4x4 batch whose sums wrap
             ("129x4x4", (129, 4, 4), 0, 1024),
             ("67x8x8", (67, 8, 8), 0, 1024),
             ("23x6x6", (23, 6, 6), 0, 4096),
             ("9x3x5", (9, 3, 5), 0, 1024),
             ("31x1x12", (31, 1, 12), -1024, 1024),
             ("41x4x4 wrap", (41, 4, 4), -2 ** 30, 2 ** 30)]
K10_PARAMS = [(tile, name) for tile in (1, 2, 4, 8, 16, 32, 64)
              for name, shape, _, _ in K10_CASES
              if shape[1] % tile == 0 and shape[2] % tile == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,case", K10_PARAMS)
def test_dist_batch_matches_plain(cuda, tile, case):
    """satd at this tile (sse and sad beside) bit-exact with one launch
    each, on the case's inputs and on copies 4 bytes off 16-byte
    alignment."""
    from vvenc_tpu_torch.ops import rdcost as R
    _, shape, lo, hi = next(c for c in K10_CASES if c[0] == case)
    rng = np.random.RandomState(tile + 7 * shape[0])
    a, b = (torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int32))
            .to(cuda) for _ in range(2))
    for x, y in ((a, b), (_off(a, 1, cuda), _off(b, 3, cuda))):
        for name, kern, plain, args in (
                ("satd_batch", R.satd_batch, R.satd_batch_ref, (tile,)),
                ("sad_batch", R.sad_batch, R.sad_batch_ref, ()),
                ("sse_batch", R.sse_batch, R.sse_batch_ref, ())):
            c0 = kernels.launches[name]
            got, want = kern(x, y, *args), plain(a, b, *args)
            torch.cuda.synchronize()
            assert kernels.launches[name] == c0 + 1
            assert torch.equal(got, want), (name, shape, x.data_ptr() % 16)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32, 64])
def test_satd_batch_writes_every_element_of_an_uninitialised_output(cuda,
                                                                    tile):
    """vt_satd_batch stores every element once and reads nothing of out:
    an output full of garbage comes back equal to the plain version."""
    from vvenc_tpu_torch.ops import rdcost as R
    rng = np.random.RandomState(tile)
    for shape in ((29, 64, 64), (3, 128, 64)):
        a, b = (torch.from_numpy(rng.randint(-512, 512, shape)
                                 .astype(np.int32)).to(cuda)
                for _ in range(2))
        out = torch.full((shape[0],), -123456789, dtype=torch.int32,
                         device=cuda)
        R._launch("satd_batch", "vt_satd_batch", a, b, out, tile)
        torch.cuda.synchronize()
        assert torch.equal(out, R.satd_batch_ref(a, b, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(4, 4), (8, 8), (16, 16), (64, 64), (6, 6)])
def test_sse_sad_write_every_element_past_one_wave(cuda, H, W):
    """vt_sse_batch / vt_sad_batch store every element once and read
    nothing of out: batches of more elements than one wave of blocks
    takes in a step (the blocks loop), into outputs full of garbage, on
    aligned inputs and on views 4 bytes off alignment."""
    from vvenc_tpu_torch.ops import rdcost as R
    B = (1 << 21) // (H * W) + 77
    rng = np.random.RandomState(H * W)
    a, b = (torch.from_numpy(rng.randint(0, 1024, (B, H, W))
                             .astype(np.int32)).to(cuda) for _ in range(2))
    for x, y in ((a, b), (_off(a, 1, cuda), _off(b, 2, cuda))):
        for name, dtype, plain in (("sse_batch", torch.float32,
                                    R.sse_batch_ref),
                                   ("sad_batch", torch.int32,
                                    R.sad_batch_ref)):
            out = torch.full((B,), -7, dtype=dtype, device=cuda)
            R._launch(name, f"vt_{name}", x, y, out)
            torch.cuda.synchronize()
            assert torch.equal(out, plain(a, b)), (name, x.data_ptr() % 16)


@pytest.mark.cuda
def test_k8_k10_resource_queries(cuda):
    """vt_mc_batch_attrs for every kind at the H.266 sizes (and the generic
    widths), vt_dist_batch_attrs for every tile: no stack, spill or local
    memory, at least one resident block an SM."""
    sizes = [(n, w, h) for n in (8, 4) for w, h in K8_SIZES]
    for n, w, h in sizes:
        for kind in range(4):
            r = kernels.resources("mc_batch", "vt_mc_batch_attrs", w, h, n,
                                  kind)
            assert r["local_bytes"] == 0, (n, w, h, kind, r)
            assert r["blocks_per_sm"] >= 1, (n, w, h, kind, r)
    for tile in (1, 2, 4, 8, 16, 32, 64):
        for H, W in ((16, 16), (64, 64), (64, 128)):
            if H % tile or W % tile:
                continue
            r = kernels.resources("dist_batch", "vt_dist_batch_attrs", tile,
                                  H, W)
            assert r["local_bytes"] == 0, (tile, H, W, r)
            assert r["blocks_per_sm"] >= 1, (tile, H, W, r)
    # sse and sad (vt_sse_sad_attrs), K7 on both paths
    for sse in (0, 1):
        for H, W in ((4, 4), (8, 8), (16, 16), (64, 64), (6, 6)):
            r = kernels.resources("dist_batch", "vt_sse_sad_attrs", sse, H,
                                  W)
            assert r["local_bytes"] == 0 and r["blocks_per_sm"] >= 1, r
        for vec in (0, 1):
            r = kernels.resources("quant_batch", "vt_quant_batch_attrs", sse,
                                  vec)
            assert r["local_bytes"] == 0 and r["blocks_per_sm"] >= 1, r


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_mode_costs_matches_plain(cuda, s, bd):
    from vvenc_tpu_torch.ops import intra_batch as IB
    rng = np.random.RandomState(s + bd)
    B = 19
    tops = rng.randint(0, 1 << bd, (B, 2 * s + 3)).astype(np.int32)
    lefts = rng.randint(0, 1 << bd, (B, 2 * s + 3)).astype(np.int32)
    lefts[:, 0] = tops[:, 0]
    tops[0] = lefts[0] = (1 << bd) - 1
    tops[1] = lefts[1] = 0
    src = rng.randint(0, 1 << bd, (B, s, s)).astype(np.int32)
    rm = IB.build_ref_mains(tops, lefts, s, s)
    args = [torch.from_numpy(a).to(cuda) for a in (src, rm, tops, lefts)]
    c0 = kernels.launches["mode_costs"]
    got = IB.mode_costs_batch(*args, s, s, bd)
    want = IB.mode_costs_batch_ref(*args, s, s, bd)
    torch.cuda.synchronize()
    assert kernels.launches["mode_costs"] == c0 + 1
    assert torch.equal(got, want)


def _checker_plane(W, H, bd, pad):
    """A 0 / max checkerboard, edge-padded: every residual at its
    extreme."""
    yy, xx = np.mgrid[:H, :W]
    src = np.where((yy + xx) % 2 == 0, (1 << bd) - 1, 0).astype(np.int32)
    return torch.from_numpy(np.pad(src, pad, mode="edge").astype(np.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("case", ["ragged", "single", "checker"])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (64, 64), (4, 16),
                                 (32, 8), (8, 64)])
def test_presel_costs_groups_and_extremes(cuda, w, h, case, bd):
    """K4's two entries bit-exact against presel_costs_ref on a last
    candidate group that is not full (the class grid of a 136x72 plane,
    and a batch of 37), on a single candidate, and on a 0 / max
    checkerboard (0 / 255 at 8 bits, 0 / 1023 at 10)."""
    pad = S.FramePresel.PAD
    rng = np.random.RandomState(w * 7 + h)
    W, H = 136, 72
    plane = (_checker_plane(W, H, bd, pad) if case == "checker"
             else _plane(rng, W, H, bd, pad)).to(cuda)
    xs, ys, _, _ = S._class_grid(W, H, w, h, True)
    if case == "single":                       # the last grid position
        xs, ys = xs[-1:], ys[-1:]
    xs_d = torch.from_numpy(xs).to(cuda)
    ys_d = torch.from_numpy(ys).to(cuda)
    inputs = S.plane_inputs(plane, pad, xs, ys, w, h)
    want = S.presel_costs_ref(*inputs, w, h, bd)
    n = dict(kernels.launches)
    got_plane = S.presel_costs_plane(plane, pad, xs_d, ys_d, w, h, bd)
    got_gathered = S.presel_costs(*inputs, w, h, bd)
    torch.cuda.synchronize()
    assert kernels.launches["presel_costs"] == n["presel_costs"] + 1
    assert kernels.launches["presel_costs_gathered"] == \
        n["presel_costs_gathered"] + 1
    assert torch.equal(got_plane, want) and torch.equal(got_gathered, want)
    if case == "ragged":
        sub = [x[:37] for x in inputs]
        assert torch.equal(S.presel_costs(*sub, w, h, bd), want[:37])


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (64, 64), (16, 8)])
def test_plan_trial_ties_top_k_and_qp_extremes(cuda, w, h, k, qp):
    """K3's modes equal plan_trial_ref's and its costs are within rtol 1e-5
    for k = 1, 2, 3 at QP 0 and 51: rows of equal SATD (ties go to the
    lowest mode), residuals at their extremes, the 64-point zero-out, and
    a rectangular class (the warp route)."""
    rng = np.random.RandomState(w * 3 + h + k + qp)
    B, M, bd = 23, 67, 10
    top = (1 << bd) - 1
    src = rng.randint(0, top + 1, (B, h, w)).astype(np.int32)
    src[0] = np.where(np.indices((h, w)).sum(0) % 2 == 0, top, 0)
    preds = rng.randint(0, top + 1, (B, M, h, w)).astype(np.int16)
    preds[0] = (top - src[0])[None].astype(np.int16)
    satd = rng.randint(0, 4000, (B, M)).astype(np.int32)
    satd[1] = 777
    satd[2, ::3] = 5
    lm = rng.uniform(10, 100, B).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in
            (src, preds, satd, lm, np.sqrt(lm).astype(np.float32))]
    n = kernels.launches["plan_trial"]
    mk, ck = P.plan_trial(*args, w, h, qp, bd, True, k)
    mr, cr = P.plan_trial_ref(*args, w, h, qp, bd, True, k)
    torch.cuda.synchronize()
    assert kernels.launches["plan_trial"] == n + 1
    assert torch.equal(mk, mr)
    torch.testing.assert_close(ck, cr, rtol=1e-5, atol=0)


def _class_batch(cuda, s, bd, B, seed):
    """Planning's class inputs (ops/intra_plan._class_inputs) of edge-padded
    random-walk planes, cut or tiled to B candidates."""
    rng = np.random.RandomState(seed)
    top = (1 << bd) - 1
    W, H = 256, 128
    walk = np.cumsum(rng.randint(-9, 10, (2, H, W)), axis=2)
    srcs = np.clip(walk + top // 2 + rng.randint(-20, 21, (2, H, W)), 0,
                   top).astype(np.int16)
    srcs[0, :8] = top                         # clip paths
    srcs[1, :8] = 0
    planes = torch.from_numpy(np.stack(
        [np.pad(x, P.PAD, mode="edge") for x in srcs])).to(cuda)
    blocks, tops, lefts = P._class_inputs(planes, s, W, H)
    idx = torch.arange(B, device=cuda) % blocks.shape[0]
    lm = torch.from_numpy(rng.uniform(10, 100, B).astype(np.float32)) \
        .to(cuda)
    return blocks[idx], tops[idx], lefts[idx], lm, lm.sqrt()


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_fused_satd_on_class_inputs_equals_k2_of_k1(cuda, s, bd):
    """K4's gathered entry on planning's class inputs is K2(K1(...)) bit
    for bit: the planning route's SATD."""
    blocks, tops, lefts, _, _ = _class_batch(cuda, s, bd, 301, s + bd)
    n = dict(kernels.launches)
    fused = S.presel_costs(blocks, tops, lefts, s, s, bd)
    two = S.satd_batch(blocks, S.predict_all_modes(tops, lefts, s, s, bd),
                       s, s)
    torch.cuda.synchronize()
    assert kernels.launches["presel_costs_gathered"] == \
        n["presel_costs_gathered"] + 1
    assert torch.equal(fused, two)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 37, 51])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("B", [0, 1, 37])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_plan_trial_refs_matches_plain(cuda, s, B, bd, qp):
    """K3's reference entry against its plain version (modes equal, costs
    within rtol 1e-5) and against the preds-form K3 on K1's predictions
    (modes and costs equal: the survivors' predictions are K1's
    integers), at every square class, 8 and 10 bits, QP 0/37/51, with B
    of 0, 1 and a ragged 37 (the warp route's blocks hold 8)."""
    blocks, tops, lefts, lm, ls = _class_batch(cuda, s, bd, B,
                                               s * 7 + B + qp + bd)
    satd = S.presel_costs(blocks, tops, lefts, s, s, bd)
    n = kernels.launches["plan_trial_refs"]
    mk, ck = P.plan_trial_refs(blocks, tops, lefts, satd, lm, ls, s, s, qp,
                               bd, True, 2)
    mr, cr = P.plan_trial_refs_ref(blocks, tops, lefts, satd, lm, ls, s, s,
                                   qp, bd, True, 2)
    preds = S.predict_all_modes(tops, lefts, s, s, bd)
    mp, cp = P.plan_trial(blocks, preds, satd, lm, ls, s, s, qp, bd, True, 2)
    torch.cuda.synchronize()
    assert kernels.launches["plan_trial_refs"] == n + (1 if B else 0)
    assert mk.shape == (B, 2) and ck.shape == (B, 2)
    assert torch.equal(mk, mr) and torch.equal(mk, mp)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(ck, cr, rtol=1e-5, atol=0)
    if B:
        # the C entry with every constant on its own gives the parameter
        # block's results
        mo, co = _refs_entry(blocks, tops, lefts, satd, lm, ls, s, s, qp, bd,
                             2)
        assert torch.equal(mo, mk) and torch.equal(co, ck)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 67])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (64, 64), (16, 8), (8, 4)])
def test_plan_trial_refs_ties_and_rectangles(cuda, w, h, k):
    """Tied SATD rows (ties to the lowest mode), k = 1, 3 and every mode
    (67), and two rectangular classes (the warp route, references LPAD
    wide)."""
    rng = np.random.RandomState(w + 5 * h + k)
    B, bd = 29, 10
    tops, lefts, src = (torch.from_numpy(a).to(cuda)
                        for a in _refs(rng, B, w, h, bd))
    satd = torch.from_numpy(rng.randint(0, 4000, (B, 67)).astype(np.int32))
    satd[1] = 777
    satd[2, ::3] = 5
    satd = satd.to(cuda)
    lm = torch.from_numpy(rng.uniform(10, 100, B).astype(np.float32)) \
        .to(cuda)
    args = (src, tops, lefts, satd, lm, lm.sqrt())
    mk, ck = P.plan_trial_refs(*args, w, h, 37, bd, True, k)
    mr, cr = P.plan_trial_refs_ref(*args, w, h, 37, bd, True, k)
    torch.cuda.synchronize()
    assert torch.equal(mk, mr)
    assert mk[1].tolist() == list(range(k))
    torch.testing.assert_close(ck, cr, rtol=1e-5, atol=0)


def _refs_entry(blocks, tops, lefts, satd, lm, ls, w, h, qp, bd, k,
                fill=True):
    """vt_plan_trial_refs (every constant on its own) into outputs filled
    with -1 and NaN (fill) or left uninitialised, with its launch checked;
    returns (modes, costs)."""
    B = blocks.shape[0]
    dev = blocks.device
    modes = torch.empty((B, k), dtype=torch.int32, device=dev)
    costs = torch.empty((B, k), dtype=torch.float32, device=dev)
    if fill:
        modes.fill_(-1)
        costs.fill_(float("nan"))
    fn = kernels.function("plan_trial", "vt_plan_trial_refs", P._K3R_ARGS)
    kernels.check("plan_trial", fn(*P.refs_launch_args(
        blocks, tops, lefts, satd, lm, ls, modes, costs, w, h, qp, bd, True,
        k)))
    return modes, costs


def _wave(s):
    """Candidates the reference entry's grid takes in one step at class s:
    resident blocks an SM x SMs x candidates a block's step (32 at 4x4, 16
    at 8x8, 1 from 16x16)."""
    r = kernels.resources("plan_trial", "vt_plan_trial_refs_attrs", s, s)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return r["blocks_per_sm"] * sms * {4: 32, 8: 16}.get(s, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_plan_trial_refs_persistent_batches(cuda, s):
    """The persistent grid of K3's reference entry against its plain
    version at B = 1, B below the SM count, a B that a block's step does
    not divide, and B one past a full wave of the grid (every block
    takes a second step, one takes a third); every output written (the
    outputs filled with -1 and NaN, and left uninitialised)."""
    bd, qp, wave = 10, 37, _wave(s)
    for B in sorted({1, 100, 37 * 3, wave + 1}):
        blocks, tops, lefts, lm, ls = _class_batch(cuda, s, bd, B, s + B)
        satd = S.presel_costs(blocks, tops, lefts, s, s, bd)
        mr, cr = P.plan_trial_refs_ref(blocks, tops, lefts, satd, lm, ls, s,
                                       s, qp, bd, True, 2)
        for fill in (True, False):
            mk, ck = _refs_entry(blocks, tops, lefts, satd, lm, ls, s, s, qp,
                                 bd, 2, fill)
            torch.cuda.synchronize()
            assert torch.equal(mk, mr), (s, B, fill)
            torch.testing.assert_close(ck, cr, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_plan_trial_refs_wide_references(cuda, s):
    """tops and lefts wider than LPAD (rows of Lt = LPAD + 7 and Ll =
    LPAD + 2 ints, so no row starts 16-byte aligned) and a source view 4
    bytes off 16-byte alignment: the kernel reads the first LPAD of each
    row and stages the source at any alignment."""
    bd, B = 8, 45
    blocks, tops, lefts, lm, ls = _class_batch(cuda, s, bd, B, 7 * s)
    L = tops.shape[1]
    rng = np.random.RandomState(s)
    wt = torch.from_numpy(rng.randint(0, 256, (B, L + 7)).astype(np.int32)) \
        .to(cuda)
    wl = torch.from_numpy(rng.randint(0, 256, (B, L + 2)).astype(np.int32)) \
        .to(cuda)
    wt[:, :L] = tops
    wl[:, :L] = lefts
    flat = torch.empty(B * s * s + 1, dtype=torch.int32, device=cuda)
    off = flat[1:].view(B, s, s)
    off.copy_(blocks)
    satd = S.presel_costs(blocks, tops, lefts, s, s, bd)
    mr, cr = P.plan_trial_refs_ref(blocks, tops, lefts, satd, lm, ls, s, s,
                                   22, bd, True, 2)
    mk, ck = P.plan_trial_refs(off, wt, wl, satd, lm, ls, s, s, 22, bd, True,
                               2)
    torch.cuda.synchronize()
    assert torch.equal(mk, mr)
    torch.testing.assert_close(ck, cr, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_plan_trial_refs_resources(cuda, s):
    """The kernel of each square class and entry: the threads of its
    design (256; at 16x16 the reference entry's 128, two survivors at a
    time, and the preds form's 64, a block a candidate), at least two
    resident blocks an SM (three at 64x64, whose 70 KB of shared memory
    were sized for three) and at most a few spilled words."""
    for symbol, t16 in (("vt_plan_trial_refs_attrs", 128),
                        ("vt_plan_trial_attrs", 64)):
        r = kernels.resources("plan_trial", symbol, s, s)
        assert r["threads"] == (t16 if s == 16 else 256), (symbol, r)
        assert r["blocks_per_sm"] >= (3 if s == 64 else 2), (symbol, r)
        assert r["local_bytes"] <= 64, (symbol, r)


@pytest.mark.cuda
def test_plan_class_core_on_the_card_writes_no_predictions(cuda):
    """_plan_class_core on a CUDA device: the fused SATD and K3's
    reference entry, one launch each, no K1 or K2, and no [B, 67, h, w]
    buffer (peak memory well under its size); the result equals the CPU
    route's."""
    s, bd, B = 8, 10, 4096
    blocks, tops, lefts, lm, ls = _class_batch(cuda, s, bd, B, 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    mk, ck = P._plan_class_core(blocks, tops, lefts, lm, ls, s, s, 43, bd,
                                True, 2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "presel_costs_gathered": 1, "plan_trial_refs": 1}
    assert peak < B * 67 * s * s * 2 // 4
    mr, cr = P._plan_class_core(*(x.cpu() for x in (blocks, tops, lefts, lm,
                                                     ls)), s, s, 43, bd, True,
                                2)
    assert torch.equal(mk.cpu(), mr)
    torch.testing.assert_close(ck.cpu(), cr, rtol=1e-5, atol=0)


def _me_case(kind, W, H, bd, rng):
    """(src, ref) sample planes of a K5 edge case at bit depth bd."""
    top = (1 << bd) - 1
    if kind == "random":
        base = rng.randint(0, top + 1, (H + 40, W + 40))
        return base[10:10 + H, 12:12 + W], base[13:13 + H, 7:7 + W]
    if kind == "flat":                       # every candidate ties
        return np.full((H, W), top // 3), np.full((H, W), top // 2)
    if kind == "max_vs_zero":
        return np.full((H, W), top), np.zeros((H, W), np.int64)
    yy, xx = np.mgrid[:H, :W]
    cell = 4 if kind == "pooled_checker" else 1
    c = np.where((yy // cell + xx // cell) % 2 == 0, top, 0)
    return c, top - c


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 11])
@pytest.mark.parametrize("kind", ["random", "flat", "max_vs_zero",
                                  "pooled_checker", "checker"])
@pytest.mark.parametrize("R", [0, 4, 16, 64])
def test_frame_me_strips_ties_and_extremes(cuda, R, kind, bd):
    """K5's MVs and costs equal to frame_me_ref's on widths of 5 and 3
    blocks (a strip of 4 blocks and a ragged one, a ragged one alone), on
    flat planes (every candidate ties: the lowest index wins) and on
    0 / max planes and checkerboards at the arithmetic's extremes (11
    bits: the largest samples it takes)."""
    from vvenc_tpu_torch.ops import me as M
    rng = np.random.RandomState(R * 31 + bd)
    for W, H in ((80, 48), (48, 32)):
        src, ref = _me_case(kind, W, H, bd, rng)
        sp, rp = (torch.from_numpy(np.pad(a, M.ME_PAD, mode="edge")
                                   .astype(np.int16)).to(cuda)
                  for a in (src, ref))
        n = kernels.launches["frame_me"]
        mk, ck = M.frame_me(sp, rp, W, H, R)
        mr, cr = M.frame_me_ref(sp, rp, W, H, R)
        torch.cuda.synchronize()
        assert kernels.launches["frame_me"] == n + 1
        assert torch.equal(mk, mr), (W, H)
        assert torch.equal(ck, cr), (W, H)


def _mode_case(kind, B, s, bd, rng):
    """(src, tops, lefts) of a K11 edge case at bit depth bd."""
    top = (1 << bd) - 1
    tops = rng.randint(0, top + 1, (B, 2 * s + 3)).astype(np.int32)
    lefts = rng.randint(0, top + 1, (B, 2 * s + 3)).astype(np.int32)
    src = rng.randint(0, top + 1, (B, s, s)).astype(np.int32)
    if kind == "max_src":
        src[:], tops[:], lefts[:] = top, 0, 0
    elif kind == "zero_src":
        src[:], tops[:], lefts[:] = 0, top, top
    elif kind == "checker":
        src[:] = np.where(np.indices((s, s)).sum(0) % 2 == 0, top, 0)
        tops[:] = np.where(np.arange(2 * s + 3) % 2 == 0, top, 0)
        lefts[:] = top - tops
    lefts[:, 0] = tops[:, 0]
    return src, tops, lefts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "max_src", "zero_src", "checker"])
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_mode_costs_groups_splits_and_extremes(cuda, s, bd, kind):
    """K11 bit-exact against mode_costs_batch_ref on batches that are not
    a multiple of the thread block's group (B = 19 and 301: 301 64x64
    blocks fill the card with all modes a thread block, 19 split the
    modes), at the 0 / max extremes; 8 and 10 bits take the float32
    route, 12 the integer one."""
    from vvenc_tpu_torch.ops import intra_batch as IB
    rng = np.random.RandomState(s * 3 + bd)
    for B in (19, 301):
        src, tops, lefts = _mode_case(kind, B, s, bd, rng)
        rm = IB.build_ref_mains(tops, lefts, s, s)
        args = [torch.from_numpy(a).to(cuda) for a in (src, rm, tops, lefts)]
        c0 = kernels.launches["mode_costs"]
        got = IB.mode_costs_batch(*args, s, s, bd)
        want = IB.mode_costs_batch_ref(*args, s, s, bd)
        torch.cuda.synchronize()
        assert kernels.launches["mode_costs"] == c0 + 1
        assert torch.equal(got, want), B


@pytest.mark.cuda
def test_mode_costs_integer_route_wraps_as_int32(cuda):
    """Above 10 bits K11 keeps the reference's int32 arithmetic, wrapping
    included: samples of 30 bits overflow the 4-tap sums and the
    Hadamard."""
    from vvenc_tpu_torch.ops import intra_batch as IB
    rng = np.random.RandomState(5)
    for s in (4, 16):
        src, tops, lefts = _mode_case("random", 7, s, 30, rng)
        rm = IB.build_ref_mains(tops, lefts, s, s)
        args = [torch.from_numpy(a).to(cuda) for a in (src, rm, tops, lefts)]
        got = IB.mode_costs_batch(*args, s, s, 30)
        assert torch.equal(got, IB.mode_costs_batch_ref(*args, s, s, 30))


# ---------------------------------------------------------------------------
# K9 full_search_sse: the float32 route (sample ranges within 1023) and the
# integer route, patches, groups of blocks, ties
# ---------------------------------------------------------------------------

def _search_case(rng, B, h, w, ah, aw, bd, kind="random"):
    """(blocks [B, h, w], areas [B, ah, aw]) int32 at bit depth bd."""
    top = (1 << bd) - 1
    if kind == "flat":
        return (np.full((B, h, w), top // 3, np.int32),
                np.full((B, ah, aw), top // 3, np.int32))
    if kind == "checker":
        blk = np.where(np.indices((h, w)).sum(0) % 2 == 0, top, 0)
        area = np.where(np.indices((ah, aw)).sum(0) % 2 == 0, 0, top)
        return (np.broadcast_to(blk, (B, h, w)).astype(np.int32).copy(),
                np.broadcast_to(area, (B, ah, aw)).astype(np.int32).copy())
    return (rng.randint(0, top + 1, (B, h, w)).astype(np.int32),
            rng.randint(0, top + 1, (B, ah, aw)).astype(np.int32))


def _check_search(cuda, blocks, areas, h, w):
    from vvenc_tpu_torch.ops import me as M
    b, a = (torch.from_numpy(x).to(cuda) for x in (blocks, areas))
    c0 = kernels.launches["full_search_sse"]
    got = M.full_search_sse_batch(b, a, h, w)
    want = M.full_search_sse_batch_ref(b, a, h, w)
    torch.cuda.synchronize()
    assert kernels.launches["full_search_sse"] == c0 + 1
    assert torch.equal(got, want)
    my, mx, cost = M.best_mv_batch(b, a, h, w)
    idx = want.flatten(1).argmin(dim=1)
    gw = want.shape[2]
    assert torch.equal(my * gw + mx, idx)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("R", [0, 1, 16, 64])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_full_search_sizes_ranges_and_groups(cuda, s, R):
    """K9 equal to full_search_sse_batch_ref (costs and argmins) on 10-bit
    data for square blocks 4..64 and R 0, 1, 16, 64, with one block and
    with a batch that does not fill the last thread block's group."""
    rng = np.random.RandomState(s * 7 + R)
    for B in (1, 37):
        _check_search(cuda, *_search_case(rng, B, s, s, s + 2 * R,
                                          s + 2 * R, 10), s, s)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,ah,aw", [
    (8, 16, 14, 56), (16, 4, 48, 14), (4, 12, 21, 40), (32, 8, 40, 72),
    (6, 10, 20, 17), (16, 16, 48, 80), (64, 32, 80, 64)])
def test_full_search_rectangular_blocks_and_areas(cuda, h, w, ah, aw):
    """Rectangular blocks and areas (ah != aw, odd grids), at 8 and 10
    bits; 6x10 (w not a multiple of 4) takes the integer route."""
    rng = np.random.RandomState(h * 31 + w + ah + aw)
    for bd in (8, 10):
        _check_search(cuda, *_search_case(rng, 23, h, w, ah, aw, bd), h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("s,R", [(4, 4), (8, 8), (16, 16), (64, 16)])
def test_full_search_flat_planes_tie_to_the_lowest_index(cuda, s, R):
    """Flat block and area: every displacement ties at 0 and the lowest
    index wins."""
    from vvenc_tpu_torch.ops import me as M
    blocks, areas = _search_case(None, 9, s, s, s + 2 * R, s + 2 * R, 10,
                                 "flat")
    got = _check_search(cuda, blocks, areas, s, s)
    assert float(got.abs().max()) == 0.0
    b, a = (torch.from_numpy(x).to(cuda) for x in (blocks, areas))
    my, mx, _ = M.best_mv_batch(b, a, s, s)
    assert int(my.abs().sum()) == 0 and int(mx.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12, 16])
@pytest.mark.parametrize("s,R", [(8, 8), (16, 16), (64, 16)])
def test_full_search_checkerboards_at_both_routes(cuda, s, R, bd):
    """0 / max checkerboards (every SSE at its largest: 64x64 at 10 bits
    is 4096 * 1023^2, just below 2^32): 8 and 10 bits take the float
    route, 12 and 16 the integer one; a batch mixing 10-bit blocks with
    one 12-bit block sends its thread block to the integer route."""
    blocks, areas = _search_case(None, 11, s, s, s + 2 * R, s + 2 * R, bd,
                                 "checker")
    _check_search(cuda, blocks, areas, s, s)
    if bd == 12:
        rng = np.random.RandomState(s + R)
        b10, a10 = _search_case(rng, 11, s, s, s + 2 * R, s + 2 * R, 10)
        b10[5], a10[5] = blocks[5], areas[5]
        _check_search(cuda, b10, a10, s, s)


@pytest.mark.cuda
def test_full_search_largest_area_that_fits(cuda):
    """The largest area a 16x16 block takes (block and area within the
    232,448 bytes of shared memory a thread block can use: 241 x 240) is
    searched exactly; one row more is refused."""
    from vvenc_tpu_torch.ops import me as M
    rng = np.random.RandomState(3)
    _check_search(cuda, *_search_case(rng, 2, 16, 16, 241, 240, 10), 16, 16)
    b, a = (torch.from_numpy(x).to(cuda) for x in
            _search_case(rng, 2, 16, 16, 242, 240, 10))
    with pytest.raises(RuntimeError):
        M.full_search_sse_batch(b, a, 16, 16)


# ---------------------------------------------------------------------------
# K6 transform_batch: every (w, h) pair, the tensor-core stages, the
# integer route, groups and alignment
# ---------------------------------------------------------------------------

ALL_TR_PAIRS = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)]


def _tr_check(cuda, T, x, w, h, bd):
    """fwd and inv of x [B, h, w] (numpy int32) against the plain
    versions; inv also on the forward output and on clipped extremes."""
    t = torch.from_numpy(x).to(cuda)
    n = dict(kernels.launches)
    ck = T.fwd_transform_batch(t, w, h, bd)
    assert torch.equal(ck, T.fwd_transform_batch_ref(t, w, h, bd))
    assert torch.equal(T.inv_transform_batch(t, w, h, bd),
                       T.inv_transform_batch_ref(t, w, h, bd))
    assert torch.equal(T.inv_transform_batch(ck, w, h, bd),
                       T.inv_transform_batch_ref(ck, w, h, bd))
    torch.cuda.synchronize()
    assert kernels.launches["fwd_transform_batch"] == \
        n["fwd_transform_batch"] + 1
    assert kernels.launches["inv_transform_batch"] == \
        n["inv_transform_batch"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12, 16])
@pytest.mark.parametrize("w,h", ALL_TR_PAIRS)
def test_transform_all_pairs_bit_depths_and_groups(cuda, w, h, bd):
    """K6 bit-exact on all 25 (w, h) pairs at 8, 10, 12 and 16 bits:
    residuals at +-(2^bd - 1) (16 bits: past 2^15, the integer route),
    coefficients at -2^15 and 2^15 - 1, one block and a batch that is not
    a multiple of the group."""
    from vvenc_tpu_torch.ops import transforms as T
    rng = np.random.RandomState(w * 100 + h + bd)
    top = (1 << bd) - 1
    for B in (1, 2048 // (w * h) + 3 if w * h < 2048 else 3):
        x = rng.randint(-top, top + 1, (B, h, w)).astype(np.int32)
        x[0, 0, :] = top
        x[-1, -1, :] = -top
        _tr_check(cuda, T, x, w, h, bd)
        c = rng.choice([-(1 << 15), (1 << 15) - 1], (B, h, w))
        _tr_check(cuda, T, c.astype(np.int32), w, h, bd)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", ALL_TR_PAIRS)
def test_transform_integer_route_wraps_as_int32(cuda, w, h):
    """Inputs of +-2^15 and far beyond (+-2^20, +-2^30: the reference's
    int32 sums wrap) send their group to the integer route, which wraps
    as the reference does; the other groups of the batch stay on the
    tensor cores.  A tensor 4 bytes off 16-byte alignment takes the
    4-byte copies."""
    from vvenc_tpu_torch.ops import transforms as T
    rng = np.random.RandomState(w * 7 + h)
    G = max(1, 2048 // (w * h))
    B = 3 * G + 1
    x = rng.randint(-1023, 1024, (B, h, w)).astype(np.int32)
    x[G] = rng.choice([-(1 << 15), 1 << 15, -(1 << 20), 1 << 30], (h, w))
    x[2 * G + G // 2, 0, 0] = -(1 << 15) - 1
    _tr_check(cuda, T, x, w, h, 10)
    t = torch.from_numpy(x).to(cuda)
    buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=cuda)
    off = buf[1:].view(B, h, w)
    off.copy_(t)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(T.fwd_transform_batch(off, w, h, 10),
                       T.fwd_transform_batch_ref(t, w, h, 10))
    assert torch.equal(T.inv_transform_batch(off, w, h, 10),
                       T.inv_transform_batch_ref(t, w, h, 10))


# ---------------------------------------------------------------------------
# K1 intra_pred_all and K2 satd_modes: every class, bit depths, batches,
# strides, alignment, M and the int16 wrap
# ---------------------------------------------------------------------------

ALL_K1_CLASSES = [(w, h) for w in (4, 8, 16, 32, 64)
                  for h in (4, 8, 16, 32, 64)]


def _k1_inputs(rng, B, w, h, bd, extra=0):
    """tops/lefts [B, LPAD + extra] (row stride past LPAD when extra > 0)
    and source blocks [B, h, w]; the first block's references alternate
    between the rails."""
    L = _shape_tables(w, h, True, 0).LPAD + extra
    tops = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    lefts = rng.randint(0, 1 << bd, (B, L)).astype(np.int32)
    tops[0, ::2] = lefts[0, 1::2] = (1 << bd) - 1
    tops[0, 1::2] = lefts[0, ::2] = 0
    src = rng.randint(0, 1 << bd, (B, h, w)).astype(np.int32)
    return tops, lefts, src


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("w,h", ALL_K1_CLASSES)
def test_intra_pred_all_every_class_batch_and_stride(cuda, w, h, bd):
    """K1 bit-exact on all 25 classes at 8, 10 and 12 bits: one block, a
    batch that is not a multiple of any split (the whole card for a small
    batch, one item a block for a large one), references wider than LPAD;
    one launch per call."""
    rng = np.random.RandomState(w * 131 + h * 7 + bd)
    for B, extra in ((1, 0), (37, 5), (613, 0)):
        tops, lefts, _ = (torch.from_numpy(a).to(cuda)
                          for a in _k1_inputs(rng, B, w, h, bd, extra))
        n = kernels.launches["intra_pred_all"]
        pk = S.predict_all_modes(tops, lefts, w, h, bd)
        pr = S.predict_all_modes_ref(tops, lefts, w, h, bd)
        torch.cuda.synchronize()
        assert kernels.launches["intra_pred_all"] == n + 1
        assert pk.shape == (B, 67, h, w) and pk.dtype == torch.int16
        assert torch.equal(pk, pr), (B, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("w,h", ALL_K1_CLASSES)
def test_satd_modes_every_class_batch_and_m(cuda, w, h, bd):
    """K2 bit-exact on all 25 classes at 8, 10 and 12 bits, for M = 67, 1,
    5 and 35 and batches of 1 and 45 blocks; one launch per call."""
    rng = np.random.RandomState(w * 17 + h * 3 + bd)
    for B, M in ((1, 67), (45, 67), (45, 1), (3, 5), (29, 35)):
        src = torch.from_numpy(
            rng.randint(0, 1 << bd, (B, h, w)).astype(np.int32)).to(cuda)
        preds = torch.from_numpy(
            rng.randint(0, 1 << bd, (B, M, h, w)).astype(np.int16)).to(cuda)
        n = kernels.launches["satd_modes"]
        sk = S.satd_batch(src, preds, w, h)
        sr = S.satd_batch_ref(src, preds, w, h)
        torch.cuda.synchronize()
        assert kernels.launches["satd_modes"] == n + 1
        assert sk.shape == (B, M) and sk.dtype == torch.int32
        assert torch.equal(sk, sr), (B, M)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (64, 64), (4, 16),
                                 (16, 8), (8, 32), (32, 64)])
def test_satd_modes_int16_wrap_extremes(cuda, w, h):
    """Sources and predictions at opposite rails, up to 0 against 65535
    (the int16 -1) and 65535 against 0: int16(src) - pred wraps as the
    reference's int16 subtraction does, and the largest Hadamard
    intermediates pass through the fused last stage."""
    B, M = 4, 6
    src = np.full((B, h, w), 1023, np.int32)
    src[1] = 0
    src[2, ::2] = 65535
    src[3] = -32768
    preds = np.zeros((B, M, h, w), np.int16)
    preds[:, 0] = -1                    # 65535 as int16
    preds[:, 1] = 32767
    preds[:, 2, 1::2] = -32768
    preds[:, 3] = 1023
    preds[:, 4, :, ::3] = -1
    src_t = torch.from_numpy(src).to(cuda)
    preds_t = torch.from_numpy(preds).to(cuda)
    assert torch.equal(S.satd_batch(src_t, preds_t, w, h),
                       S.satd_batch_ref(src_t, preds_t, w, h))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (8, 4), (4, 16),
                                 (32, 32)])
def test_k1_k2_take_tensors_off_16_byte_alignment(cuda, w, h):
    """Predictions 2 bytes off 16-byte alignment (K2 takes them through
    2-byte loads) and references 4 bytes off (K1 reads them a word at a
    time): both exact."""
    rng = np.random.RandomState(w + 5 * h)
    B, M = 21, 67
    tops, lefts, src = (torch.from_numpy(a).to(cuda)
                        for a in _k1_inputs(rng, B, w, h, 10, 3))

    def off(t, k):
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device=cuda)
        v = buf[k:].view(t.shape)
        v.copy_(t)
        return v

    t_off, l_off = off(tops, 1), off(lefts, 3)
    assert t_off.data_ptr() % 16 == 4
    pk = S.predict_all_modes(t_off, l_off, w, h, 10)
    assert torch.equal(pk, S.predict_all_modes_ref(tops, lefts, w, h, 10))
    p_off = off(pk, 1)
    assert p_off.data_ptr() % 16 == 2
    s_off = off(src, 1)
    n = kernels.launches["satd_modes"]
    sk = S.satd_batch(s_off, p_off, w, h)
    torch.cuda.synchronize()
    assert kernels.launches["satd_modes"] == n + 1
    assert sk.shape == (B, M)
    assert torch.equal(sk, S.satd_batch_ref(src, pk, w, h))


@pytest.mark.cuda
def test_k1_k2_resource_queries(cuda):
    """vt_intra_pred_all_attrs / vt_satd_modes_attrs on every class: no
    stack, spill or local memory, at least one resident block an SM."""
    for w, h in ALL_K1_CLASSES:
        for src, sym in (("intra_pred_all", "vt_intra_pred_all_attrs"),
                         ("satd_modes", "vt_satd_modes_attrs")):
            r = kernels.resources(src, sym, w, h)
            assert r["local_bytes"] == 0, (sym, w, h, r)
            assert r["blocks_per_sm"] >= 1, (sym, w, h, r)
