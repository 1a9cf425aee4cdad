"""The port's batched transforms and quantisers (what kernels K6 and K7
compute) against the JAX package's fwd_transform_batch,
inv_transform_batch, quant_batch and dequant_batch: the plain versions,
which the wrappers run on the CPU, bit-exact (integer outputs) on seeded
residuals, both bit depths, QPs 0..51 and both slice types, with the
64-point zero-out and the left-shift dequant branch covered."""

import numpy as np
import pytest
import torch

import vvenc_tpu.ops.transforms as JT
import vvenc_tpu_torch.ops.transforms as TT

# (h, w): tests/test_transforms.py's shapes plus 64x32 (h = 64)
SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (16, 8),
          (64, 32)]
QPS = (0, 22, 37, 42, 51)


def _residuals(h, w, bd, seed):
    """Seeded residuals spanning the bit depth, with an all-max and an
    all-min block (the clip paths)."""
    rng = np.random.RandomState(seed)
    top = (1 << bd) - 1
    resi = rng.randint(-top, top + 1, (6, h, w)).astype(np.int32)
    resi[0] = top
    resi[1] = -top
    return resi


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", SHAPES)
def test_transforms_and_quantisers_match_jax(h, w, bd):
    resi = _residuals(h, w, bd, seed=h * 100 + w + bd)
    t = torch.from_numpy
    coeff = np.array(JT.fwd_transform_batch(resi, w, h, bd))
    got = TT.fwd_transform_batch(t(resi), w, h, bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), coeff)
    if w > 32 or h > 32:                          # 64-point zero-out
        assert not coeff[:, 32:, :].any() and not coeff[:, :, 32:].any()
    np.testing.assert_array_equal(
        TT.inv_transform_batch(t(coeff), w, h, bd).numpy(),
        np.asarray(JT.inv_transform_batch(coeff, w, h, bd)))
    for qp in QPS:
        for intra in (True, False):
            q = np.array(JT.quant_batch(coeff, w, h, qp, bd, intra))
            np.testing.assert_array_equal(
                TT.quant_batch(t(coeff), w, h, qp, bd, intra).numpy(), q,
                err_msg=f"quant qp {qp} intra {intra}")
        # levels past int16 exercise the dequant's input clip
        q[0, 0, 0], q[1, 0, 0] = 40000, -40000
        np.testing.assert_array_equal(
            TT.dequant_batch(t(q), w, h, qp, bd).numpy(),
            np.asarray(JT.dequant_batch(q, w, h, qp, bd)),
            err_msg=f"dequant qp {qp}")


@pytest.mark.parametrize("w,h,bd,qp", [(4, 4, 10, 18), (64, 64, 10, 42),
                                       (4, 4, 8, 12), (16, 8, 8, 30)])
def test_dequant_left_shift_branch_matches_jax(w, h, bd, qp):
    """right_shift = 6 - (tshift + qp // 6) <= 0: the dequant scales by a
    left shift (from QP 18 on 4x4 and QP 42 on 64x64 at 10 bits)."""
    row, tshift = TT._quant_shift(w, h, bd)
    assert 6 - (tshift + qp // 6) <= 0
    rng = np.random.RandomState(qp)
    q = rng.randint(-300, 301, (5, h, w)).astype(np.int32)
    np.testing.assert_array_equal(
        TT.dequant_batch(torch.from_numpy(q), w, h, qp, bd).numpy(),
        np.asarray(JT.dequant_batch(q, w, h, qp, bd)))


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((2, 4, 4), dtype=torch.int32, device="meta")
    for fn in (TT.fwd_transform_batch, TT.inv_transform_batch):
        with pytest.raises(ValueError, match="no kernel"):
            fn(x, 4, 4, 10)
    with pytest.raises(ValueError, match="no kernel"):
        TT.quant_batch(x, 4, 4, 30, 10)
    with pytest.raises(ValueError, match="no kernel"):
        TT.dequant_batch(x, 4, 4, 30, 10)
