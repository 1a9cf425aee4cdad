"""The roofline counts at known shapes, and the rd cost's arithmetic."""

import numpy as np
import pytest

from benchmark import check, spec


def test_plan_block_work_at_8x8():
    rl = spec.roofline("plan")
    nbytes, f32, tc = rl.block_work(8, 2)
    assert nbytes == 4 * 64 + 8 * 19 + 8 + 16
    # prediction (60 x 7 + 8) + SATD 67 x (1 + 6 + 2) + top-k + 2 trials
    assert f32 == (428 + 67 * 9) * 64 + 134 + 2 * 17 * 64
    assert tc == 2 * 2 * 2 * 16 * 64
    assert rl.is_kernel("void presel_costs_kernel<8, true>(Inputs, int*)")
    assert rl.is_kernel("void plan_refs_tc_kernel<16>(Inputs, TrialParams)")
    assert not rl.is_kernel("void frame_me_kernel(short const*)")


def test_plan_least_time_is_bound_by_operations():
    rl, pk = spec.roofline("plan"), spec.peaks()
    W, H = 416, 240
    work = {(s, 2, 10): 10 * (W // s) * (H // s) for s in (8, 16, 32, 64)}
    t, bound = rl.least_seconds(work, pk)
    assert bound == "operations"
    assert 4e-5 < t < 8e-5


def test_rd_cost_lambda_is_vvencs_at_the_cells_qp():
    lam = spec.reader("rd_cost_per_frame").lambda_for
    assert lam({"qp": 37, "internal_bit_depth": 10}) == \
        pytest.approx(0.57 * 2 ** (37 / 3))
    assert lam({"qp": 32, "internal_bit_depth": 10}) == \
        pytest.approx(926.5342, rel=1e-6)


def test_rd_cost_sums_sse_at_the_internal_depth_and_the_stream_bits():
    src = (np.full((4, 4), 10, np.uint8), np.full((2, 2), 20, np.uint8),
           np.full((2, 2), 30, np.uint8))
    rec = (np.full((4, 4), 41, np.int32), np.full((2, 2), 80, np.int32),
           np.full((2, 2), 118, np.int32))
    # 10-bit: src << 2 = 40, 80, 120 -> SSE 16 * 1 + 0 + 4 * 4
    assert check.sse(rec, src, 2) == 32
    assert check.rd_cost([rec, rec], [src, src], 2, 100.0, 5) == \
        pytest.approx((64 + 100.0 * 40) / 2)
