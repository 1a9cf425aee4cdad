"""The benchmark's reference (benchmark/reference, a frozen copy of the
port's decoder and of its plain planning version) against the port on
the CPU at tiny sizes, and its control."""

import pytest
import torch

from benchmark import check, clip
from benchmark.reference import plan as ref_plan
from benchmark.tests.tiny import OVERRIDES, tiny_run


@pytest.mark.parametrize("kind", ["ai", "ra"])
def test_reference_decoder_reads_what_the_port_writes(kind):
    from vvenc_tpu_torch.decoder import decode_stream
    run, out = tiny_run(kind, seconds=0.5)
    assert out["correct"], out["checks"]
    # the harness's judged stream, decoded by both decoders
    stream = run.kept_stream
    a = check.decode_in_order(stream)
    b = sorted(decode_stream(stream), key=lambda f: f.poc)
    assert len(a) == len(b) == OVERRIDES[kind]["clip_frames"]
    for x, y in zip(a, b):
        assert check.same_picture(x, y.planes)


def _tiny_planes(seed=3):
    pics = clip.make_clip(seed, 128, 64, 2, OVERRIDES["ai"]["clip"])
    return ref_plan.padded_planes([p[0] for p in pics], 2)


def test_reference_plan_equals_the_ports_plain_route():
    from vvenc_tpu_torch.ops import intra_plan
    planes = _tiny_planes()
    lam = ref_plan.plan_lambda(46)
    args = ([lam] * 2, [lam ** 0.5] * 2, (8, 16, 32, 64), 128, 64, 46, 10,
            True, 2)
    rm, rc = ref_plan.plan_batch(planes, *args)
    pm, pc = intra_plan._plan_batch_core(
        planes, torch.tensor(args[0]), torch.tensor(args[1]), *args[2:])
    assert torch.equal(rm, pm) and torch.equal(rc, pc)


def test_plan_control_in_bfloat16_fails_the_comparison():
    planes = _tiny_planes()
    lam = ref_plan.plan_lambda(46)
    args = ([lam] * 2, [lam ** 0.5] * 2, (8, 16, 32, 64), 128, 64, 46, 10,
            True, 2)
    rm, rc = ref_plan.plan_batch(planes, *args)
    bm, bc = ref_plan.plan_batch(planes, *args, dtype=torch.bfloat16)
    same = bm == rm
    gap = float(((bc - rc).abs() / rc.abs().clamp_min(1.0))[same].max())
    assert int((bm != rm).sum()) > 0 or gap > 1e-3
