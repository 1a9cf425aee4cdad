"""The port's library entry points on the CPU (device="cpu"): the
streaming VVEncImpl (state machine, streaming == batch for all-intra, RA
and RA + MCTF), ffapp on a .cfg file, and the C shim driven by a C
client; every stream byte-identical to the JAX package's for the same
options, and decoded."""

import shutil

import numpy as np
import pytest

from vvenc_tpu import api as JA
from vvenc_tpu import capi as JC
from vvenc_tpu import ffapp as JF
from vvenc_tpu.config.config import VvencTpuConfig as JConfig
from vvenc_tpu.decoder import decode_stream
from vvenc_tpu_torch import capi_c
from vvenc_tpu_torch import ffapp as PF
from vvenc_tpu_torch.api import (VVENC_ERR_INITIALIZE, VVENC_ERR_PARAMETER,
                                 VVENC_ERR_RESTART_REQUIRED,
                                 VVENC_ERR_UNSPECIFIED, VVENC_OK, State,
                                 VVEncImpl)
from vvenc_tpu_torch.config import VvencTpuConfig
from vvenc_tpu_torch.encoder.intra_encoder import IntraEncoder


def _frames(w, h, n, seed=5):
    rng = np.random.RandomState(seed)
    base = rng.randint(40, 200, (h + n, w + n)).astype(np.uint8)
    out = []
    for t in range(n):
        y = base[t:t + h, t:t + w]
        u = np.full((h // 2, w // 2), 100 + 3 * t, np.uint8)
        out.append((y, u, 255 - u))
    return out


def _stream(impl, frames):
    out = bytearray()
    for f in frames:
        au, done, rc = impl.encode(f)
        assert rc == VVENC_OK and not done
        out += au
    au, done, rc = impl.encode(None)
    assert rc == VVENC_OK and done
    return bytes(out + au)


def test_state_machine():
    impl = VVEncImpl()
    _, _, rc = impl.encode(None)
    assert rc == VVENC_ERR_INITIALIZE
    cfg = VvencTpuConfig(width=64, height=64, qp=32, ctu_size=32,
                         device="cpu")
    assert impl.init(cfg) == VVENC_OK
    assert impl.state == State.INITIALIZED
    assert impl.init(cfg) == VVENC_ERR_INITIALIZE
    assert impl.get_headers()[:4] == b"\x00\x00\x00\x01"
    import copy
    moved = copy.deepcopy(cfg)
    moved.width = 128
    assert impl.reconfig(moved) == VVENC_ERR_RESTART_REQUIRED
    fr = _frames(64, 64, 1)[0]
    au, done, rc = impl.encode(fr)
    assert rc == VVENC_OK and not done and au
    assert [p for p, _ in impl.take_recons()] == [0]
    au, done, rc = impl.encode(None)
    assert rc == VVENC_OK and done
    _, _, rc = impl.encode(fr)
    assert rc == VVENC_ERR_UNSPECIFIED
    assert impl.close() == VVENC_OK
    assert impl.state == State.UNINITIALIZED
    assert VVEncImpl().init(VvencTpuConfig(width=0, height=64,
                                           device="cpu")) \
        == VVENC_ERR_PARAMETER


# the tests of tests/test_api.py: (options, frames)
CASES = {
    "all_intra": (dict(width=64, height=64, qp=32, ctu_size=32,
                       intra_period=1), _frames(64, 64, 3)),
    "ra": (dict(width=64, height=64, qp=32, ctu_size=32, intra_period=0,
                gop_size=4, deblocking=1, sao=1), _frames(64, 64, 11)),
    "ra_mctf": (dict(width=64, height=64, qp=34, ctu_size=32, gop_size=8,
                     intra_period=0, mctf=2, bim=1),
                _frames(64, 64, 20, seed=9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_matches_batch_and_jax(case):
    opts, frames = CASES[case]
    impl = VVEncImpl()
    assert impl.init(VvencTpuConfig(device="cpu", **opts)) == VVENC_OK
    stream = _stream(impl, frames)
    # batch: the encoder the CLI builds from the same flat config
    from vvenc_tpu_torch.__main__ import encoder_config_from
    from vvenc_tpu_torch.config.config import apply_derived
    cfg = VvencTpuConfig(device="cpu", **opts)
    apply_derived(cfg)
    ecfg = encoder_config_from(cfg, None)
    assert ecfg.device == "cpu"
    batch = IntraEncoder(ecfg).encode_sequence(list(frames))
    assert stream == batch, "streaming != batch bitstream"
    ref = JA.VVEncImpl()
    assert ref.init(JConfig(**opts)) == JA.VVENC_OK
    out = bytearray()
    for f in frames:
        out += ref.encode(f)[0]
    out += ref.encode(None)[0]
    assert stream == bytes(out), "port != JAX package stream"
    assert len(decode_stream(stream)) == len(frames)


def test_device_reaches_the_encoder():
    """VvencTpuConfig.device reaches IntraEncoder through
    encoder_config_from; its default is "cuda"."""
    from vvenc_tpu_torch.__main__ import encoder_config_from
    assert encoder_config_from(VvencTpuConfig(width=64, height=64),
                               None).device == "cuda"
    impl = VVEncImpl()
    assert impl.init(VvencTpuConfig(width=64, height=64,
                                    device="cpu")) == VVENC_OK
    assert impl._enc.cfg.device == "cpu"


def test_ffapp_cfg_matches_jax(tmp_path):
    w, h, n = 64, 64, 3
    clip = tmp_path / "c.yuv"
    with open(clip, "wb") as f:
        for y, u, v in _frames(w, h, n, seed=3):
            f.write(y.tobytes() + u.tobytes() + v.tobytes())
    cfg = tmp_path / "enc.cfg"
    cfg.write_text(f"# config 1's options, cut to {w}x{h}\n"
                   f"InputFile : {clip}\nSourceWidth : {w}\n"
                   f"SourceHeight : {h}\nFramesToBeEncoded : {n}\n"
                   "QP : 37\nIntraPeriod : 1\nPreset : faster\n")
    port, ref = tmp_path / "port.266", tmp_path / "ref.266"
    assert PF.main(["-c", str(cfg), f"BitstreamFile={port}", "Device=cpu",
                    "--verify"]) == 0
    assert JF.main(["-c", str(cfg), f"BitstreamFile={ref}"]) == 0
    assert port.read_bytes() == ref.read_bytes()
    assert len(decode_stream(port.read_bytes())) == n


def test_c_shim_encodes_through_a_c_client(tmp_path):
    """The port's C shim (g++ against libpython) driven by its C client
    with device=cpu: the stream equals the JAX package's C API path
    (vvenc_tpu.capi) on the same pictures, and decodes."""
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("g++/gcc not found")
    try:
        capi_c.python_link()
    except RuntimeError as e:
        pytest.skip(str(e))
    w, h, n = 64, 64, 2
    params = "width=64;height=64;qp=37;intra_period=1;gop_size=1"
    out = tmp_path / "capi.266"
    r = capi_c.run_client(out, params + ";device=cpu", w, h, n)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "capi ok" in r.stdout and "vvenc_tpu_torch" in r.stdout
    data = out.read_bytes()
    handle = JC.capi_open(params)
    ref = b"".join(JC.capi_encode(handle, y.tobytes(), u.tobytes(),
                                  v.tobytes())
                   for y, u, v in capi_c.client_frames(w, h, n))
    ref += JC.capi_flush(handle)
    JC.capi_close(handle)
    assert data == ref
    frames = decode_stream(data)
    assert len(frames) == n and frames[0].planes[0].shape == (h, w)

