"""The port's mesh path (vvenc_tpu_torch.parallel.mesh and the MESH hooks)
against the JAX package's, on the CPU: the port's mesh has 8 CPU
positions in the shape and with the axis names of the JAX package's
8-device virtual mesh (tests/conftest.py), so both shard the same way.
Everything compared is integer and bit-exact, except the f32 plan costs
(rtol 1e-5, as tests/test_torch_intra_plan.py); streams are
byte-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import vvenc_tpu.parallel.mesh as JM
import vvenc_tpu_torch.parallel.mesh as TM
from test_device_plan import _clip
from test_mesh import _inputs


@pytest.fixture
def jmesh2d():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return JM.make_mesh2d(jax.devices()[:8])


def _port_mesh(jmesh):
    """The port's mesh of CPU positions with the JAX mesh's shape and
    axis names."""
    return TM.Mesh(np.full(jmesh.devices.shape, "cpu", dtype=object),
                   jmesh.axis_names)


def _eq(port, ref, what=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("s,case", [(16, "random"), (8, "random"),
                                    (8, "tie")])
def test_search_step_matches_jax(s, case):
    src, tops, lefts = _inputs(12, s, s, seed=s)
    if case == "tie":
        # constant references: every mode predicts the same block, so
        # every SATD ties and the first minimum (planar) wins
        tops[:] = 512
        lefts[:] = 512
    ref = JM.search_step(src, tops, lefts, w=s, h=s, qp=40)
    got = TM.search_step(*_t(src, tops, lefts), w=s, h=s, qp=40)
    for name, g, r in zip(("best", "levels", "recon", "bits", "sse"), got,
                          ref):
        _eq(g, r, name)
    assert got[0].dtype == torch.int32 and got[4].dtype == torch.int64
    if case == "tie":
        assert not got[0].any()
    # the plain route is the same function
    plain = TM.search_step_ref(*_t(src, tops, lefts), w=s, h=s, qp=40)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_sharded_search_step_matches_jax():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    w = h = 16
    src, tops, lefts = _inputs(16, w, h, seed=1)
    jmesh = JM.make_mesh(jax.devices()[:8])
    jstep = JM.sharded_search_step(jmesh, w=w, h=h, qp=40)
    ref = jstep(*(JM.shard_batch(jmesh, x) for x in (src, tops, lefts)))
    mesh = _port_mesh(jmesh)
    step = TM.sharded_search_step(mesh, w=w, h=h, qp=40)
    got = step(*(TM.shard_batch(mesh, x) for x in _t(src, tops, lefts)))
    for g, r in zip(got, ref):
        _eq(g, r)
    # whole tensors are sharded by the step itself
    for g, g2 in zip(got, step(*_t(src, tops, lefts))):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("tl", [1, 2])
def test_sharded_encode_step2d_matches_jax(jmesh2d, tl):
    """tl tile columns per position: with tl = 2 the ppermute moves whole
    shards, so a column receives the apron of the column tl to its left
    (the reference's own program is the comparison, not a replay)."""
    w = h = 16
    g_ax, t_ax = jmesh2d.devices.shape
    gg, tt, b = (2 if tl == 1 else 1) * g_ax, tl * t_ax, 2
    src, tops, lefts = _inputs(gg * tt * b, w, h, seed=2 + tl)

    def grid(x):
        return x.reshape((gg, tt, b) + x.shape[1:])

    def put(x):
        return jax.device_put(grid(x), NamedSharding(jmesh2d,
                                                     P("gops", "tiles")))
    ref = JM.sharded_encode_step2d(jmesh2d, w=w, h=h, qp=40)(
        put(src), put(src), put(tops), put(lefts))
    step = TM.sharded_encode_step2d(_port_mesh(jmesh2d), w=w, h=h, qp=40)
    got = step(*(torch.from_numpy(grid(x)) for x in (src, src, tops,
                                                      lefts)))
    for name, g, r in zip(("best", "levels", "recon", "per_gop", "total"),
                          got, ref):
        _eq(g, r, name)
    assert got[3].shape == (gg,)
    # against the whole-shard replay: a roll by tl tile columns
    _b1, _q1, r1, bits1, sse1 = TM.search_step(*_t(src, tops, lefts), w=w,
                                               h=h, qp=40)
    nbr = torch.roll(r1.reshape(gg, tt, b, h, w)[..., -1], tl,
                     dims=1).reshape(-1, h)
    L = lefts.shape[1]
    lefts2 = torch.cat([nbr[:, :1], nbr, nbr[:, -1:].expand(-1, L - h - 1)],
                       dim=1)
    _b2, _q2, r2, bits2, sse2 = TM.search_step(
        *_t(src, tops), lefts2, w=w, h=h, qp=40)
    better = sse2 + bits2.to(torch.int64) < sse1 + bits1.to(torch.int64)
    assert torch.equal(got[2], torch.where(better[:, None, None], r2, r1)
                       .reshape(gg, tt, b, h, w))


def test_sharded_presel_costs_matches_jax(jmesh2d):
    """A batch that does not divide (19 blocks on 8 positions) and a
    rectangular class."""
    mesh = _port_mesh(jmesh2d)
    rng = np.random.RandomState(3)
    for (w, h), batch in (((8, 8), 19), ((16, 8), 24)):
        src = rng.randint(0, 1024, (batch, h, w)).astype(np.int32)
        tops = rng.randint(0, 1024, (batch, 2 * w + 3)).astype(np.int32)
        lefts = rng.randint(0, 1024, (batch, 2 * h + 3)).astype(np.int32)
        jc, jt = JM.sharded_presel_costs(jmesh2d, src, tops, lefts, w=w,
                                         h=h, bit_depth=10)
        costs, total = TM.sharded_presel_costs(mesh, *_t(src, tops, lefts),
                                               w=w, h=h, bit_depth=10)
        _eq(costs, jc, f"{w}x{h}")
        assert int(total) == int(jt) and total.dtype == torch.int64


def test_sharded_plan_class_matches_jax(jmesh2d):
    """19 blocks on 8 positions: blocks padded with zeros, the lambdas
    with ones, outputs cut back to 19."""
    from test_torch_intra_plan import _class_inputs
    s = 8
    src, tops, lefts, lm, ls = _class_inputs(s, 19, seed=5)
    jm, jc = JM.sharded_plan_class(
        jmesh2d, *(jnp.asarray(a) for a in (src, tops, lefts, lm, ls)),
        w=s, h=s, qp=37, bit_depth=10, implicit_mts=True, k=2)
    m, c = TM.sharded_plan_class(_port_mesh(jmesh2d),
                                 *_t(src, tops, lefts, lm, ls), w=s, h=s,
                                 qp=37, bit_depth=10, implicit_mts=True,
                                 k=2)
    _eq(m, jm)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=0)


def test_mesh_shapes_and_shard_batch():
    mesh = TM.make_mesh2d(["cpu"] * 8)
    assert mesh.shape == {"gops": 4, "tiles": 2} and mesh.size == 8
    assert TM.make_mesh2d(["cpu"] * 4).shape == {"gops": 2, "tiles": 2}
    assert TM.make_mesh2d(["cpu"] * 3).shape == {"gops": 1, "tiles": 3}
    assert mesh.describe() == "8 positions (gops 4 x tiles 2) on the CPU"
    x = torch.arange(16).reshape(16, 1)
    with pytest.raises(ValueError, match="axes"):
        TM.shard_batch(mesh, x, "tiles")
    shards = TM.shard_batch(mesh, x, ("gops", "tiles"))
    assert [int(s[0]) for s in shards] == list(range(0, 16, 2))
    with pytest.raises(ValueError, match="divide"):
        TM.shard_batch(TM.make_mesh(["cpu"] * 3), x)


def _mesh_cfg(frames, **kw):
    from vvenc_tpu.encoder.intra_encoder import EncoderConfig as JaxConfig
    # tests/test_device_plan.py's encoder options; explicit MTS off, so
    # that the native CTU search codes every picture from its plan
    return JaxConfig(width=frames[0][0].shape[1],
                     height=frames[0][0].shape[0], qp=34, ctu_size=64,
                     intra_period=1, gop_size=1, dual_tree=True,
                     num_full_rd_modes=2, mts=False, sao=False, alf=False,
                     deblocking=True, device_rd="on", **kw)


def test_plan_mesh_e2e_byte_identical_to_jax(jmesh2d):
    """The port's encode with intra_plan.MESH (8 CPU positions) writes
    the byte-identical stream to vvenc_tpu's encode with its MESH (the
    8-device virtual mesh), and vvenc_tpu's decoder decodes it."""
    from vvenc_tpu import native as jax_native
    from vvenc_tpu.decoder import decode_stream
    from vvenc_tpu.encoder.intra_encoder import IntraEncoder as JaxEncoder
    from vvenc_tpu.ops import intra_plan as JL
    from vvenc_tpu_torch import native
    from vvenc_tpu_torch.config import config_from_dict
    from vvenc_tpu_torch.encoder.intra_encoder import IntraEncoder
    from vvenc_tpu_torch.ops import intra_plan as TL
    if not (native.available() and jax_native.available()):
        pytest.skip("native library unavailable (no g++)")
    frames = _clip(n=2)
    JL.MESH = jmesh2d
    try:
        ref = JaxEncoder(_mesh_cfg(frames)).encode_sequence(frames)
    finally:
        JL.MESH = None
    assert TL.MESH is None
    TL.MESH = _port_mesh(jmesh2d)
    try:
        enc = IntraEncoder(config_from_dict(
            dataclasses.asdict(_mesh_cfg(frames)), device="cpu"))
        out = enc.encode_sequence(frames)
    finally:
        TL.MESH = None
    assert not enc._plan_bank        # every plan was consumed
    assert out == ref and len(out) > 0
    assert len(decode_stream(out)) == len(frames)


def test_presel_mesh_cli_byte_identical_to_jax(jmesh2d, tmp_path):
    """tests/test_mesh.py's chip-count-invariance CLI case on the port:
    the device preselection sharded over 8 CPU positions
    (intra_presel.MESH) writes vvenc_tpu's stream."""
    from vvenc_tpu import native as jax_native
    from vvenc_tpu.__main__ import main as jax_main
    from vvenc_tpu.decoder import decode_stream
    from vvenc_tpu_torch import native
    from vvenc_tpu_torch.__main__ import main
    from vvenc_tpu_torch.ops import intra_presel as TS
    if not (native.available() and jax_native.available()):
        pytest.skip("native library unavailable (no g++)")
    w, h, n = 64, 64, 2
    rng = np.random.RandomState(9)
    yuv = tmp_path / "clip.yuv"
    with open(yuv, "wb") as f:
        for i in range(n):
            y = np.clip(rng.randint(0, 255, (h, w)) // 2
                        + np.arange(w)[None, :] + 3 * i, 0,
                        255).astype(np.uint8)
            c = (y[::2, ::2] // 2 + 64).astype(np.uint8)
            f.write(y.tobytes())
            f.write(c.tobytes())
            f.write(c.tobytes())
    args = ["-i", str(yuv), "-s", f"{w}x{h}", "-q", "35", "-f", str(n),
            "--preset", "faster", "--intra-period", "1",
            "--set", "intra_presel=source"]
    assert jax_main(args + ["-o", str(tmp_path / "j.266")]) == 0
    assert TS.MESH is None
    TS.MESH = _port_mesh(jmesh2d)
    try:
        assert main(args + ["-o", str(tmp_path / "t.266"), "--device",
                            "cpu", "--verify"]) == 0
    finally:
        TS.MESH = None
    a = (tmp_path / "j.266").read_bytes()
    assert len(a) > 0 and a == (tmp_path / "t.266").read_bytes()
    assert len(decode_stream(a)) == n
