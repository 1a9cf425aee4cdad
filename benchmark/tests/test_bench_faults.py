"""The harness drives a whole run with the timed path broken underneath
and sees `correct` come out false, once for each fault the cell can have
(CPU, tiny sizes, the kernels' plain versions; the harness's look for a
card is skipped by calling it directly).  The cell runs on one chip, so
no exchange between chips exists to leave out.
"""

import pytest
import torch

from benchmark import check
from benchmark.tests.tiny import tiny_run


@pytest.mark.parametrize("kind", ["ai", "ra"])
def test_sound_runs_are_correct(kind):
    _, out = tiny_run(kind, seconds=0.5)
    assert out["correct"], (kind, out["checks"])


def test_planning_state_left_unchanged(monkeypatch):
    """Every planning call returns the first call's plan again (one
    thread: the prefill plans the clip in batches of 2)."""
    from vvenc_tpu_torch.ops import intra_plan
    orig = intra_plan._plan_batch_core
    first = []

    def stale(*a, **k):
        out = orig(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    monkeypatch.setattr(intra_plan, "_plan_batch_core", stale)
    _, out = tiny_run(seconds=0.5, cfg={"set": {"device_rd": "on",
                                                "threads": 1},
                                        "warm_frames": 2})
    assert not out["correct"], out["checks"]


def test_half_of_the_batch_left_out(monkeypatch):
    """The planning batch's second half is not planned from its pictures:
    it gets the mean of the first half's pictures."""
    from vvenc_tpu_torch.ops import intra_plan
    orig = intra_plan._plan_batch_core

    def half(planes, *a, **k):
        F = planes.shape[0]
        if F > 1:
            keep = planes[:F // 2]
            mean = keep.to(torch.float32).mean(0).round().to(planes.dtype)
            planes = torch.cat([keep, mean.expand(F - F // 2, *mean.shape)])
        return orig(planes, *a, **k)
    monkeypatch.setattr(intra_plan, "_plan_batch_core", half)
    _, out = tiny_run(seconds=0.5)
    assert not out["correct"], out["checks"]


def test_a_planned_mode_altered(monkeypatch):
    from vvenc_tpu_torch.ops import intra_plan
    orig = intra_plan._plan_batch_core

    def altered(*a, **k):
        modes, costs = orig(*a, **k)
        modes = modes.clone()
        modes[0, 0] = (modes[0, 0] + 1) % 67
        return modes, costs
    monkeypatch.setattr(intra_plan, "_plan_batch_core", altered)
    _, out = tiny_run(seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["ai", "ra"])
def test_a_stream_byte_altered(monkeypatch, kind):
    """One bit of the last slice flipped where the CLI's encoder
    produces the stream."""
    from vvenc_tpu_torch.encoder import intra_encoder
    orig = intra_encoder.IntraEncoder.encode_sequence

    def flipped(self, frames):
        s = bytearray(orig(self, frames))
        s[-3] ^= 0x10
        return bytes(s)
    monkeypatch.setattr(intra_encoder.IntraEncoder, "encode_sequence",
                        flipped)
    _, out = tiny_run(kind, seconds=0.5)
    assert not out["correct"], out["checks"]


def test_plan_control_is_not_correct():
    """The control, the reference's plan in bfloat16 in the program's
    place, fails the cell's plan numbers (tiny size; the card test
    test_bench_control runs it at the cell's own size)."""
    run, out = tiny_run(seconds=0.5)
    shift = run.cfg["internal_bit_depth"] - run.cfg["input_bit_depth"]
    lumas = [p[0] for p in run.driver_pictures]
    nums = check.judge_plans(run.probes.plans, lumas, shift, control=True)
    ok, rows = check.verdict(nums, {k: v for k, v in run.limits.items()
                                    if k in nums})
    assert not ok, rows


def test_only_the_judged_pictures_are_kept():
    """The probes keep one plane a judged picture, no whole batch."""
    run, out = tiny_run(seconds=0.5, cfg={"clip_frames": 6})
    kept = sorted(p["picture"] for p in run.probes.plans)
    assert kept == sorted(run.plan_sample) and len(kept) == 4
    assert out["info"]["kept_device_bytes"] == 4 * (64 + 160) * (128 + 160) * 2
    assert out["correct"], out["checks"]
