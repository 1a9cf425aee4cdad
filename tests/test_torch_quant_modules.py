"""The port's copies of the three host modules that only some options
reach (ops/rdoq.py, ops/depquant.py, encoder/filmgrain.py) give what the
JAX package's give: the same levels on seeded random TUs, the same film
grain SEI payload, and byte-identical streams through the options that
reach them."""

import dataclasses

import numpy as np
import pytest

from vvenc_tpu import native as jax_native
from vvenc_tpu.bitstream.cabac import CtxModels as JaxCtx
from vvenc_tpu.encoder import filmgrain as jax_fg
from vvenc_tpu.encoder.intra_encoder import EncoderConfig as JaxConfig
from vvenc_tpu.encoder.intra_encoder import IntraEncoder as JaxEncoder
from vvenc_tpu.ops import depquant as jax_dq
from vvenc_tpu.ops import rdoq as jax_rdoq
from vvenc_tpu.ops import transforms as JT
from vvenc_tpu_torch import native
from vvenc_tpu_torch.bitstream.cabac import CtxModels
from vvenc_tpu_torch.config import config_from_dict
from vvenc_tpu_torch.encoder import filmgrain
from vvenc_tpu_torch.encoder.intra_encoder import IntraEncoder
from vvenc_tpu_torch.ops import depquant, rdoq


def _lambda(qp):
    return 0.57 * 2.0 ** ((qp - 12) / 3.0) * 16


def _ctx_pair(qp):
    a, b = JaxCtx(), CtxModels()
    a.init(min(qp, 51), 2)
    b.init(min(qp, 51), 2)
    return a, b


def _tus(rng, h, w):
    """tests/test_rdoq.py's three residual kinds, forward-transformed."""
    yy, xx = np.mgrid[0:h, 0:w]
    for resi in ((rng.randn(h, w) * 60).astype(np.int32),
                 (yy * 7 + xx * 3 - 40 + rng.randn(h, w) * 10).astype(
                     np.int32),
                 (rng.randn(h, w) * 200).astype(np.int32)):
        yield JT.fwd_transform_np(resi, 10)


SHAPES = [(4, 4), (8, 8), (32, 32), (4, 16), (16, 4), (2, 8), (32, 8)]


@pytest.mark.parametrize("qp", [22, 32, 42])
@pytest.mark.parametrize("luma", [True, False])
def test_rdoq_levels_equal_to_jax_package(qp, luma):
    lm = _lambda(qp)
    ja, tc = _ctx_pair(qp)
    for h, w in SHAPES:
        rng = np.random.RandomState(qp + h * 64 + w)
        for coeff in _tus(rng, h, w):
            want = jax_rdoq._rdoq_py(coeff, qp, 10, luma, lm, ja, None)
            got = rdoq._rdoq_py(coeff, qp, 10, luma, lm, tc, None)
            np.testing.assert_array_equal(got, want)
            # the dispatcher (the native kernel where there is one)
            np.testing.assert_array_equal(
                rdoq.rdoq_np(coeff, qp, 10, luma, lm, tc, None),
                jax_rdoq.rdoq_np(coeff, qp, 10, luma, lm, ja, None))


@pytest.mark.parametrize("qp", [22, 32, 42])
@pytest.mark.parametrize("luma", [True, False])
def test_depquant_levels_equal_to_jax_package(qp, luma):
    lm = _lambda(qp)
    ja, tc = _ctx_pair(qp)
    for h, w in SHAPES:
        rng = np.random.RandomState(qp + h * 64 + w)
        for coeff in _tus(rng, h, w):
            want = jax_dq.depquant_np(coeff, qp, 10, luma, lm, ja)
            got = depquant.depquant_np(coeff, qp, 10, luma, lm, tc)
            np.testing.assert_array_equal(got, want)


def _noisy(seed, h, w, sigma):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    clean = 60 + 0.5 * xx + 0.3 * yy + 40 * (xx > w // 2)
    return np.clip(clean + rng.randn(h, w) * sigma, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sigma", [0.0, 6.0])
def test_film_grain_sei_payload_equal_to_jax_package(sigma):
    frames = [_noisy(3 + i, 128, 128, sigma) for i in range(2)]
    want = jax_fg.derive_fgc_sei(frames)
    got = filmgrain.derive_fgc_sei(frames)
    if sigma == 0.0:
        assert want is None and got is None
        return
    assert want is not None and got is not None
    assert got.payload() == want.payload()
    assert filmgrain.SEI_FILM_GRAIN == jax_fg.SEI_FILM_GRAIN


def _clip64():
    """One 64x64 picture: a gradient with a hard edge under strong seeded
    noise, so that most TUs code many levels."""
    rng = np.random.RandomState(11)
    y = _noisy(11, 64, 64, 25.0)
    u = np.clip(128 + rng.randn(32, 32) * 12, 0, 255).astype(np.uint8)
    v = np.clip(110 + rng.randn(32, 32) * 12, 0, 255).astype(np.uint8)
    return [{0: y, 1: u, 2: v}]


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("case", ["mts_lfnst", "film_grain",
                                  "dep_quant_no_native"])
def test_stream_byte_identical_to_jax_package(monkeypatch, case):
    """The encodes that raised ModuleNotFoundError in the port before it
    had these modules: explicit MTS + LFNST on the Python searcher with
    RDOQ (dep_quant off, EncoderConfig's default), film grain, and
    dependent quantisation without the native library."""
    kw = {"mts_lfnst": dict(mts=True, lfnst=True),
          "film_grain": dict(mts=True, lfnst=True, film_grain=True),
          "dep_quant_no_native": dict(dep_quant=True)}[case]
    if case == "dep_quant_no_native":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
        calls = _count_calls(monkeypatch, depquant, "depquant_np")
    elif case == "mts_lfnst":
        calls = _count_calls(monkeypatch, rdoq, "rdoq_np")
    else:
        calls = _count_calls(monkeypatch, filmgrain, "derive_fgc_sei")
    frames = _clip64()
    jc = JaxConfig(width=64, height=64, **kw)
    ref = JaxEncoder(jc).encode_sequence(frames)
    enc = IntraEncoder(config_from_dict(dataclasses.asdict(jc),
                                        device="cpu"))
    out = enc.encode_sequence(frames)
    assert calls, "the port's module was not reached"
    assert out == ref and len(out) > 0
