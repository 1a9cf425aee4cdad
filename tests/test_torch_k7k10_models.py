"""The data flow of K10's sse and sad entries as the kernel on the card
runs it (csrc/dist_batch.cu dist_kernel), held in numpy against the JAX
reference (vvenc_tpu/ops/rdcost.py sse_batch, sad_batch), and K7's index
map (csrc/quant_batch.cu k7_kernel).  A CUDA kernel has no CPU mode, so
these models are what the CPU can check of the kernels' arithmetic and
of the way they cut the work; tests/test_torch_kernels.py holds the
kernels themselves on the card.

An element's U units (16-byte vectors of 4 samples when both inputs are
16-byte aligned and H W is a multiple of 4, else single samples: the
4-byte path) go to TE threads, a power of two of about U / 2 up to 256;
thread ti reads units ti, ti + TE, ... two at a time.  Small elements
share a warp (LPE = TE lanes each), larger ones take WPE = TE / 32 warps.
The lanes' partial sums meet by a segmented shuffle-down, the warps'
through shared memory, and one thread stores the element.  A wave of
blocks loops over the elements.  sse sums the squares of the int32
differences modulo 2^64 and rounds once to float32; sad sums |d| modulo
2^32.

K7 (quant, dequant; elementwise): thread t of the grid's S threads takes
the tensor's units (16-byte vectors when input and output are 16-byte
aligned, else samples) t, t + S, ... two at a time; on the vector path
the first n % 4 threads then take the samples past the last vector.  A
wave of about two units a thread, at most the resident blocks.
"""

import jax
import numpy as np
import pytest

from vvenc_tpu.ops import rdcost as JR

THREADS = 256
WAVE = 132 * 8          # an H100's SMs times eight resident blocks


def dist_plan(B, n, aligned, wave=WAVE):
    """(vec, U, LPE, WPE, elements a block step, grid) of
    csrc/dist_batch.cu dist_plan() for B elements of n samples."""
    vec = aligned and n % 4 == 0
    U = n // 4 if vec else n
    te = 1
    while te < (U + 1) // 2 and te < THREADS:
        te *= 2
    lpe, wpe = (te, 1) if te < 32 else (32, te // 32)
    epb = (THREADS // 32 // wpe) * (32 // lpe)
    return vec, U, lpe, wpe, epb, min(-(-B // epb), wave)


def thread_units(U, te, ti):
    """The units thread ti of an element reads, in the order of its
    loads: pairs (u, u + te), then a last single one."""
    out, u = [], ti
    while u + te < U:
        out += [u, u + te]
        u += 2 * te
    if u < U:
        out.append(u)
    return out


def _shfl_down_sum(v, width):
    """acc += __shfl_down_sync(acc, o, width) for o = width / 2 .. 1 over
    the lane axis (-1) of segments of `width` lanes: a lane whose source
    lies past its segment adds its own value."""
    li = np.arange(v.shape[-1])
    o = width // 2
    while o > 0:
        src = li + o
        v = v + v[..., np.where(src < width, src, li)]
        o //= 2
    return v


def dist_model(a, b, sse, aligned=True):
    """K10 sse (sse=True) or sad on a, b [B, H, W] int32, as dist_kernel
    computes it: [B] float32 or int32."""
    B, H, W = a.shape
    n = H * W
    vec, U, lpe, wpe, _, _ = dist_plan(B, n, aligned)
    d = a.reshape(B, n).view(np.uint32) - b.reshape(B, n).view(np.uint32)
    if sse:
        ds = d.view(np.int32).astype(np.int64)
        f = (ds * ds).view(np.uint64)
    else:
        f = np.where(d.view(np.int32) < 0, np.uint32(0) - d, d)
    units = f.reshape(B, U, 4 if vec else 1).sum(axis=-1, dtype=f.dtype)
    te = lpe * wpe
    part = np.zeros((B, te), f.dtype)
    for ti in range(te):
        for u in thread_units(U, te, ti):
            part[:, ti] += units[:, u]
    lanes = _shfl_down_sum(part.reshape(B, wpe, lpe), lpe)
    tot = lanes[:, :, 0].sum(axis=1, dtype=f.dtype)
    if sse:
        return tot.view(np.int64).astype(np.float32)
    return tot.view(np.int32)


def _pair(rng, shape, lo, hi):
    return tuple(rng.randint(lo, hi, shape, dtype=np.int64).astype(np.int32)
                 for _ in range(2))


# the 1080p luma grids chip_smoke.py times (at a smaller batch), an odd
# width, a row of 12, a batch of one; (shape, low, high)
CASES = [((129, 4, 4), 0, 1024), ((67, 8, 8), 0, 1024),
         ((40, 16, 16), 0, 1024), ((3, 64, 64), 0, 1024),
         ((23, 6, 6), 0, 4096), ((31, 1, 12), -1024, 1024),
         ((1, 16, 16), 0, 1024), ((1, 64, 64), -4096, 4096),
         ((5, 3, 5), 0, 1024)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape,lo,hi", CASES)
def test_dist_model_equals_the_reference(shape, lo, hi, aligned):
    """sad equal to the reference; sse equal to the exact int64 sum
    rounded once and within rtol 1e-5 of the reference's float32 sum, on
    the vector path and the 4-byte path."""
    rng = np.random.RandomState(shape[0] * 7 + shape[2])
    a, b = _pair(rng, shape, lo, hi)
    b[0] = a[0]                                  # a zero distortion
    sad = dist_model(a, b, False, aligned)
    assert sad.dtype == np.int32
    assert np.array_equal(sad, np.asarray(JR.sad_batch(a, b)))
    sse = dist_model(a, b, True, aligned)
    exact = ((a.astype(np.int64) - b) ** 2).sum(axis=(1, 2))
    assert sse.dtype == np.float32 and sse[0] == 0.0
    assert np.array_equal(sse, exact.astype(np.float32))
    np.testing.assert_allclose(sse, np.asarray(JR.sse_batch(a, b)),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", [(4, 64, 64), (9, 16, 16), (3, 6, 6)])
def test_dist_model_sad_wraps_past_2_31_as_the_reference(shape, aligned):
    """Differences near 2^31 in magnitude: every |d| and their sum wrap
    modulo 2^32 as XLA's int32 does (the sums pass 2^31 many times)."""
    rng = np.random.RandomState(shape[1])
    a = rng.choice(np.array([2 ** 31 - 1, 2 ** 30, 12345, -7], np.int64),
                   shape).astype(np.int32)
    b = rng.choice(np.array([-2 ** 31, -2 ** 30, 0, 1023], np.int64),
                   shape).astype(np.int32)
    exact = np.abs(a.astype(np.int64) - b).sum(axis=(1, 2))
    assert (exact > 2 ** 31).all()
    want = np.asarray(JR.sad_batch(a, b))
    assert np.array_equal(dist_model(a, b, False, aligned), want)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("B,H,W", [(129, 4, 4), (67, 8, 8), (40, 16, 16),
                                   (3, 64, 64), (1, 64, 64), (23, 6, 6),
                                   (31, 1, 12), (5, 3, 5), (7, 1, 1),
                                   (300, 2, 4)])
@pytest.mark.parametrize("wave", [2, WAVE])
def test_dist_threads_read_every_unit_once_with_one_writer(B, H, W, aligned,
                                                           wave):
    """Over the grid's blocks, block steps, warps and lanes (a wave of 2
    blocks loops many steps), every (element, unit) is read by exactly
    one thread and every element is stored by exactly one thread."""
    n = H * W
    vec, U, lpe, wpe, epb, grid = dist_plan(B, n, aligned, wave)
    assert vec == (aligned and n % 4 == 0)
    te, groups, epw = lpe * wpe, THREADS // 32 // wpe, 32 // lpe
    reads = np.zeros((B, U), np.int32)
    writes = np.zeros(B, np.int32)
    for blk in range(grid):
        for e0 in range(blk * epb, B, grid * epb):
            for warp in range(THREADS // 32):
                eg, wi = divmod(warp, wpe)
                for lane in range(32):
                    e = e0 + eg * epw + lane // lpe
                    ll = lane & (lpe - 1)
                    if e < B:
                        for u in thread_units(U, te, wi * lpe + ll):
                            reads[e, u] += 1
                    if wpe == 1 and ll == 0 and e < B:
                        writes[e] += 1
            if wpe > 1:
                for t in range(groups):
                    if e0 + t < B:
                        writes[e0 + t] += 1
    assert (reads == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("s", [4, 8, 16, 64])
def test_dist_warp_loads_read_whole_sectors(s):
    """On the 1080p s x s grids each warp-wide 16-byte load of the vector
    path reads whole 32-byte sectors: the lanes of an element read
    neighbouring vectors."""
    B = {4: 129600, 8: 32400, 16: 8040, 64: 480}[s]
    vec, U, lpe, wpe, epb, grid = dist_plan(B, s * s, True)
    assert vec and lpe >= 2 and grid <= WAVE
    te, epw = lpe * wpe, 32 // lpe
    for warp in range(THREADS // 32):
        eg, wi = divmod(warp, wpe)
        loads = {}
        for lane in range(32):
            e = eg * epw + lane // lpe
            for k, u in enumerate(thread_units(U, te, wi * lpe + lane % lpe)):
                loads.setdefault(k, []).append((e * U + u) * 16)
        for addrs in loads.values():
            sectors = {}
            for x in addrs:
                sectors.setdefault(x // 32, set()).add(x % 32)
            assert all(v == {0, 16} for v in sectors.values()), (s, warp)


def test_dist_plan_at_the_1080p_grids():
    """About two units a thread: 4x4 two lanes an element, 8x8 eight,
    16x16 a warp, 64x64 the block's eight warps; a single wave."""
    assert dist_plan(129600, 16, True)[1:5] == (4, 2, 1, 128)
    assert dist_plan(32400, 64, True)[1:5] == (16, 8, 1, 32)
    assert dist_plan(8040, 256, True)[1:5] == (64, 32, 1, 8)
    assert dist_plan(480, 4096, True)[1:5] == (1024, 32, 8, 1)
    assert dist_plan(129600, 16, False)[1:5] == (16, 8, 1, 32)
    assert dist_plan(10 ** 6, 16, True)[5] == WAVE


# ---- K7 ------------------------------------------------------------------


def k7_grid(n, vec, wave=WAVE):
    """csrc/quant_batch.cu grid_for(): about two units a thread, at most
    one wave."""
    units = n // 4 if vec else n
    return min(max(1, -(-units // (2 * THREADS))), wave)


def k7_samples(n, vec, grid):
    """[(thread, sample)] in the order k7_kernel reads them (a unit's 4
    samples on the vector path)."""
    units = n // 4 if vec else n
    per = 4 if vec else 1
    S = grid * THREADS
    out = []
    for t in range(S):
        i = t
        while i + S < units:
            for u in (i, i + S):
                out += [(t, per * u + j) for j in range(per)]
            i += 2 * S
        if i < units:
            out += [(t, per * i + j) for j in range(per)]
        if vec and t < n - 4 * units:
            out.append((t, 4 * units + t))
    return out


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 7, 1003, 4099, 2 * 512 * 4 + 6])
@pytest.mark.parametrize("wave", [1, 2, WAVE])
def test_k7_threads_cover_every_sample_once(n, vec, wave):
    """Every sample is read and written by exactly one thread, n a
    multiple of 4 or not, a grid of one wave that loops (waves of 1 and 2
    blocks) or not; the vector path's tail is at most 3 samples on the
    first threads."""
    grid = k7_grid(n, vec, wave)
    seen = np.zeros(n, np.int32)
    tail = []
    for t, i in k7_samples(n, vec, grid):
        seen[i] += 1
        if vec and i >= n // 4 * 4:
            tail.append(t)
    assert (seen == 1).all()
    assert tail == list(range(n % 4 if vec else 0))


def test_k7_grid_at_the_1080p_grid():
    """The 1080p 16x16 grid's 2.06 M samples: 514,560 vectors, 1,005
    blocks of two vectors a thread, within one wave."""
    n = 8040 * 256
    assert k7_grid(n, True) == 1005 <= WAVE
    assert k7_grid(n, False) == WAVE


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
