"""The planning route the card takes (ops/intra_plan._plan_class_core on a
CUDA device): the fused 67-mode SATD (presel_costs) on planning's class
inputs, then K3's reference entry (plan_trial_refs), which predicts only
its k survivors.  Here, on the CPU, their plain versions against the JAX
package: the SATD bit-exact to satd_batch(predict_all_modes(...)), the
modes equal to its _plan_class_core and the costs within rtol 1e-5 (f32
sums in another order than XLA's)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vvenc_tpu.ops.intra_plan as JL
import vvenc_tpu.ops.intra_presel as JS
import vvenc_tpu_torch.ops.intra_plan as TL
import vvenc_tpu_torch.ops.intra_presel as TS
from vvenc_tpu_torch.ops import kernels

W, H, F = 128, 64, 2


def _planes(bd, seed):
    """F edge-padded int16 planes of smooth content with seeded noise,
    and the frames' lambdas."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    top = (1 << bd) - 1
    srcs = []
    for f in range(F):
        base = (top * (0.2 + 0.3 * np.sin(xx / (9 + f)) ** 2
                       + 0.2 * yy / H))
        srcs.append(np.clip(base + rng.randn(H, W) * top / 40, 0, top)
                    .astype(np.int16))
    planes = np.stack([np.pad(s, TL.PAD, mode="edge") for s in srcs])
    lm = rng.uniform(10, 100, F).astype(np.float32)
    return torch.from_numpy(planes), lm


def _inputs(s, bd, seed):
    planes, lm = _planes(bd, seed)
    blocks, tops, lefts = TL._class_inputs(planes, s, W, H)
    n1 = (W // s) * (H // s)
    lmb = torch.from_numpy(np.repeat(lm, n1))
    return blocks, tops, lefts, lmb, lmb.sqrt()


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_fused_satd_on_class_inputs_equals_jax(s, bd):
    blocks, tops, lefts, _, _ = _inputs(s, bd, seed=s + bd)
    assert tops.shape[1] == lefts.shape[1] == 2 * s + 3    # LPAD
    want = jax.jit(lambda b, t, l: JS.satd_batch(
        b, JS.predict_all_modes(t, l, s, s, bd), s, s))(
            *(jnp.asarray(x.numpy()) for x in (blocks, tops, lefts)))
    got = TS.presel_costs(blocks, tops, lefts, s, s, bd)   # plain version
    assert got.dtype == torch.int32 and got.shape == (blocks.shape[0], 67)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bd,qp", [(8, 22), (10, 43), (10, 51)])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_plan_trial_refs_equals_jax_plan_class_core(monkeypatch, s, bd,
                                                    qp):
    blocks, tops, lefts, lm, ls = _inputs(s, bd, seed=3 * s + qp)
    ma, ca = JL.plan_class(*(jnp.asarray(x.numpy()) for x in
                             (blocks, tops, lefts, lm, ls)),
                           w=s, h=s, qp=qp, bit_depth=bd, implicit_mts=True,
                           k=2)
    satd = TS.presel_costs(blocks, tops, lefts, s, s, bd)
    preds = TS.predict_all_modes_ref(tops, lefts, s, s, bd)
    mp, cp = TL.plan_trial_ref(blocks, preds, satd, lm, ls, s, s, qp, bd,
                               True, 2)
    # in steps of a few candidates, so the chunked gather is exercised
    monkeypatch.setattr(TL, "_class_chunk", lambda w, h: 7)
    mr, cr = TL.plan_trial_refs(blocks, tops, lefts, satd, lm, ls, s, s, qp,
                                bd, True, 2)
    assert mr.dtype == torch.int32 and cr.dtype == torch.float32
    assert torch.equal(mr, mp) and torch.equal(cr, cp)
    assert np.array_equal(mr.numpy(), np.asarray(ma))
    np.testing.assert_allclose(cr.numpy(), np.asarray(ca), rtol=1e-5,
                               atol=0)
    # the two routes of _plan_class_core agree (here both plain)
    mc, cc = TL._plan_class_core(blocks, tops, lefts, lm, ls, s, s, qp, bd,
                                 True, 2)
    assert torch.equal(mc, mr) and torch.equal(cc, cr)


def test_plan_trial_refs_ties_go_to_the_lowest_mode():
    s, B = 8, 3
    blocks, tops, lefts, lm, ls = (x[:B] for x in _inputs(s, 10, seed=1))
    satd = torch.full((B, 67), 900, dtype=torch.int32)
    satd[2, ::5] = 40
    modes, _ = TL.plan_trial_refs(blocks, tops, lefts, satd, lm,
                                  torch.zeros(B), s, s, 37, 10, True, 3)
    assert modes.tolist() == [[0, 1, 2], [0, 1, 2], [0, 5, 10]]


def test_no_fallback_off_the_cpu():
    """A tensor that is on no CPU and no card raises; nothing gives way to
    the plain version or to K1 -> K2."""
    s, B = 8, 2
    meta = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in
            (((B, s, s), torch.int32), ((B, 2 * s + 3), torch.int32),
             ((B, 2 * s + 3), torch.int32), ((B, 67), torch.int32),
             ((B,), torch.float32), ((B,), torch.float32))]
    with pytest.raises(ValueError, match="no kernel"):
        TL.plan_trial_refs(*meta, s, s, 37)
    with pytest.raises(ValueError, match="no kernel"):
        TL._plan_class_core(*meta[:3], *meta[4:], s, s, 37)


def test_k3_reference_entry_is_launch_counted():
    assert kernels.ENTRIES["plan_trial_refs"] == "plan_trial"
    assert "plan_trial_refs" in kernels.launches


def test_library_tag_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header renames every library, so a stale
    build is never loaded; an edit to another source renames only its
    own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == [
        "intra_pred.cuh", "mma_split.cuh"]
    for header in ("intra_pred.cuh", "mma_split.cuh"):
        before = {n: kernels.so_path(n) for n in kernels.SOURCES}
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        after = {n: kernels.so_path(n) for n in kernels.SOURCES}
        assert all(after[n] != before[n] for n in kernels.SOURCES), header
    with open(csrc / "satd_modes.cu", "a") as f:
        f.write("// edited\n")
    again = {n: kernels.so_path(n) for n in kernels.SOURCES}
    assert again["satd_modes"] != after["satd_modes"]
    assert all(again[n] == after[n] for n in kernels.SOURCES
               if n != "satd_modes")
