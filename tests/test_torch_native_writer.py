"""The native CTU syntax writer (vvenc_tpu_torch/native/ctu_writer.cpp)
against the Python writer, SyntaxCoder._encode_ctu_py, its specification.

Every CTU the native writer codes is also coded by the Python writer on
copies of the same state; the bytes, the arithmetic state, the contexts,
the PictureState maps, the quantization-group state, the QP, the dual
tree's luma records and the motion field must come out equal, in the CTU
loop and in the replay that puts the SAO / ALF syntax in front of each
CTU.  Encodes run the native CTU search on synthetic pictures; random
trees (written in the search's record format by _serialize) cover the
optional tools whatever the search decides.  Needs only g++."""

import copy
import dataclasses

import numpy as np
import pytest

from vvenc_tpu_torch import __main__ as cli
from vvenc_tpu_torch import native
from vvenc_tpu_torch.bitstream.bitwriter import BitWriter
from vvenc_tpu_torch.bitstream.cabac import CabacEncoder
from vvenc_tpu_torch.bitstream.params import PictureHeader, SliceHeader
from vvenc_tpu_torch.codec import ctu_syntax as CS
from vvenc_tpu_torch.codec.picture import PictureState
from vvenc_tpu_torch.codec.qp import QpState
from vvenc_tpu_torch.config import VvencTpuConfig
from vvenc_tpu_torch.config.config import Preset, apply_derived, init_preset
from vvenc_tpu_torch.decoder import decode_stream
from vvenc_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder
from vvenc_tpu_torch.native import ctu_writer as CW
from vvenc_tpu_torch.ops.mip import num_mip_modes

MAPS = ("coded_luma", "intra_mode", "is_intra", "is_mip", "cu_w", "cu_h",
        "cu_x", "cu_y", "qt_depth", "qp_map", "coded_chroma", "ccu_w",
        "ccu_h", "cqt_depth")
ENGINE = ("low", "range", "buffered_byte", "num_buffered_bytes",
          "bits_left")
QG = ("cur_qp", "qg_start", "dqp_coded", "qg_pred_qp", "_qg_delta_at")
MF = ("valid", "skipf", "isaff", "aff_valid")


@pytest.fixture(autouse=True)
def natives():
    if not native.available() or CW._lib() is None:
        pytest.skip("native library unavailable (no g++)")


def _pictures(n, w, h, seed=5):
    """Textured pictures whose chroma follows the luma (CCLM) and whose
    Cr mirrors Cb (JCCR), with noise, gratings and edges."""
    import scipy.ndimage as ndi
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = ndi.gaussian_filter(rng.rand(h, w) * 255, 2.0)
        base = (base - base.min()) / (np.ptp(base) + 1e-9) * 160 + 40
        y = base + 30 * (((xx + 2 * yy + 3 * i) // 11) % 2) \
            + 25 * np.sin(xx / (4.0 + i)) * (yy > h // 2) \
            + rng.randint(-3, 4, (h, w))
        y = np.clip(y, 0, 255)
        ys = y[::2, ::2]
        u = np.clip(ys * 0.5 + 64 + rng.randint(-2, 3, ys.shape), 0, 255)
        v = np.clip(255 - u + rng.randint(-2, 3, ys.shape), 0, 255)
        out.append((y.astype(np.uint8), u.astype(np.uint8),
                    v.astype(np.uint8)))
    return out


def _cli_config(w, h, qp, preset="FASTER", **tools):
    """The CLI's encoder options (__main__.main): 8-bit in, 10-bit
    internal, all-intra, the preset's tool set, then `tools` on the flat
    config, the default thread count as the frame-parallel pool."""
    cfg = VvencTpuConfig(width=w, height=h, qp=qp, input_bit_depth=8,
                         internal_bit_depth=10, intra_period=1, gop_size=1,
                         fps_num=50, fps_den=1, device="cpu")
    init_preset(cfg, Preset[preset])
    cfg.threads = -1
    for k, v in tools.items():
        setattr(cfg, k, v)
    apply_derived(cfg)
    if not cfg.mt_profile and cfg.threads > 0 \
            and cfg.max_parallel_frames == 0:
        cfg.max_parallel_frames = cfg.threads
    return cli.encoder_config_from(cfg, None)


def _python_writer_only(monkeypatch):
    monkeypatch.setattr(CW, "covers", lambda coder, ps: False)


class _Twin:
    """Codes every native CTU with the Python writer too, on copies, and
    compares the results (installed on SyntaxCoder.encode_ctu)."""

    def __init__(self):
        self.checked = 0
        self.coders = []
        self.orig = CS.SyntaxCoder.encode_ctu

    def __call__(self, coder, enc, ps, node):
        if coder._native_writer is None:
            coder._native_writer = CW.covers(coder, ps)
        if not (coder._native_writer and node.native_rec is not None):
            return self.orig(coder, enc, ps, node)
        enc2, ps2, node2 = (copy.deepcopy(enc), copy.deepcopy(ps),
                            copy.deepcopy(node))
        c2 = copy.copy(coder)
        c2.qp = copy.copy(coder.qp)
        c2.luma64 = dict(coder.luma64)
        c2.mf = copy.deepcopy(coder.mf)
        c2._qg_cus = list(coder._qg_cus)
        c2._encode_ctu_py(enc2, ps2, node2)
        self.orig(coder, enc, ps, node)
        _assert_same(coder, enc, ps, c2, enc2, ps2)
        self.checked += 1
        if all(c is not coder for c in self.coders):
            self.coders.append(coder)


def _assert_same(coder, enc, ps, c2, enc2, ps2):
    where = "CTU state"
    for k in ENGINE:
        assert getattr(enc, k) == getattr(enc2, k), (where, k)
    assert bytes(enc.bw._buf) == bytes(enc2.bw._buf), where
    assert enc.bw._held_bits == enc2.bw._held_bits, where
    for k in ("state0", "state1", "rate0", "rate1"):
        assert np.array_equal(getattr(enc.ctx, k), getattr(enc2.ctx, k)), k
    for m in MAPS:
        assert np.array_equal(getattr(ps, m), getattr(ps2, m)), m
    for k in QG:
        assert getattr(coder, k) == getattr(c2, k), k
    assert coder._qg_cus == c2._qg_cus == []
    assert coder.qp.qp_y == c2.qp.qp_y
    assert coder.luma64 == c2.luma64
    if coder.mf is not None:
        for k in MF:
            assert np.array_equal(getattr(coder.mf, k),
                                  getattr(c2.mf, k)), k
        assert all(a is None for a in coder.mf.aff.flat)
        assert all(a is None for a in coder.mf.ibc.flat)


def _encode_twin(monkeypatch, ecfg, frames):
    twin = _Twin()
    monkeypatch.setattr(CS.SyntaxCoder, "encode_ctu",
                        lambda coder, enc, ps, node: twin(coder, enc, ps,
                                                          node))
    CW.reset_ctu_writes()
    enc = IntraEncoder(ecfg)
    stream = enc.encode_sequence(frames)
    monkeypatch.setattr(CS.SyntaxCoder, "encode_ctu", twin.orig)
    return stream, enc, twin, dict(CW.ctu_writes)


def _n_ctus(ecfg):
    c = ecfg.ctu_size
    return -(-ecfg.width // c) * -(-ecfg.height // c)


# the cell's configuration (416x240, faster, QP 37, 8-bit in, 10-bit
# internal) with per-CTU QP, and at QP 22, CTU 128, and a size that is no
# multiple of the CTU (edge CTUs, implicit splits)
CASES = {
    "cell_qpa": (416, 240, 37, dict(perceptual_qpa=1)),
    "qp22": (416, 240, 22, {}),
    "ctu128": (256, 128, 27, dict(ctu_size=128)),
    "edge": (200, 120, 32, dict(perceptual_qpa=1)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def twin_encode(request):
    w, h, qp, tools = CASES[request.param]
    ecfg = _cli_config(w, h, qp, **tools)
    frames = _pictures(2, w, h)
    with pytest.MonkeyPatch.context() as mp:
        stream, enc, twin, writes = _encode_twin(mp, ecfg, frames)
    with pytest.MonkeyPatch.context() as mp:
        _python_writer_only(mp)
        py_stream = IntraEncoder(ecfg).encode_sequence(frames)
    return request.param, ecfg, stream, enc, twin, writes, py_stream


def test_native_writer_same_output(twin_encode):
    """Per CTU: bytes, contexts, arithmetic state and maps equal the
    Python writer's, in the CTU loop and in the SAO / ALF replay; the
    stream equals the Python writer's stream."""
    name, ecfg, stream, _, twin, writes, py_stream = twin_encode
    assert stream == py_stream
    assert writes["python"] == 0
    assert twin.checked == writes["native"] > 0
    # the replay ran: a second coder per picture
    assert len(twin.coders) == 2 * 2, name
    if name in ("cell_qpa", "edge"):
        assert all(c.use_dqp for c in twin.coders)


def test_native_writer_decodes(twin_encode):
    """The port's decoder decodes the stream to the encoder's
    reconstruction."""
    _, _, stream, enc, _, _, _ = twin_encode
    dec = decode_stream(stream)
    assert len(dec) == 2
    for fr in dec:
        for c in range(3):
            assert np.array_equal(fr.planes[c], enc.recs_by_poc[fr.poc][c])


def test_cell_configuration_writes_every_ctu_natively():
    """The benchmark cell's options (the CLI's faster preset at 416x240,
    QP 37, the CLI's default pool): 100 % native CTU writes."""
    ecfg = _cli_config(416, 240, 37)
    assert ecfg.dual_tree and ecfg.max_parallel_frames > 1
    CW.reset_ctu_writes()
    IntraEncoder(ecfg).encode_sequence(_pictures(4, 416, 240))
    writes = dict(CW.ctu_writes)
    assert writes["python"] == 0
    # four pictures, each coded in the CTU loop and the SAO / ALF replay
    assert writes["native"] == 4 * 2 * _n_ctus(ecfg)


def test_pool_stream_equals_sequential_and_python_writer(monkeypatch):
    """The all-intra pool of 4 threads (_encode_all_intra_parallel) codes
    the same stream as the sequential encode and as the Python writer."""
    frames = _pictures(4, 200, 120)
    base = _cli_config(200, 120, 37)
    pool = dataclasses.replace(base, max_parallel_frames=4)
    seq = dataclasses.replace(base, max_parallel_frames=0)
    CW.reset_ctu_writes()
    a = IntraEncoder(pool).encode_sequence(frames)
    assert CW.ctu_writes["native"] > 0 and CW.ctu_writes["python"] == 0
    b = IntraEncoder(seq).encode_sequence(frames)
    _python_writer_only(monkeypatch)
    c = IntraEncoder(seq).encode_sequence(frames)
    assert a == b == c


# ---- fallback ------------------------------------------------------------

def _fallback_config(case):
    e = _cli_config(128, 64, 32)
    if case == "explicit_mts":
        return dataclasses.replace(e, mts=True)
    if case == "transform_skip":
        return dataclasses.replace(e, transform_skip=True, scc_auto=False)
    if case == "bdpcm":
        return dataclasses.replace(e, transform_skip=True, bdpcm=True,
                                   scc_auto=False)
    if case == "ibc":
        return dataclasses.replace(e, ibc=True, scc_auto=False)
    if case == "tiles":
        e = _cli_config(256, 128, 32)
        return dataclasses.replace(e, tile_cols=2)
    return e


@pytest.mark.parametrize("case", ["explicit_mts", "transform_skip", "bdpcm",
                                  "ibc", "tiles", "dtrace"])
def test_uncovered_tools_fall_back_to_python(case, tmp_path):
    from vvenc_tpu_torch.utils.dtrace import DTRACE
    ecfg = _fallback_config(case)
    frames = _pictures(2, ecfg.width, ecfg.height)
    CW.reset_ctu_writes()
    if case == "dtrace":
        DTRACE.configure("D_CABAC:poc==0", str(tmp_path / "t.txt"))
    try:
        IntraEncoder(ecfg).encode_sequence(frames)
    finally:
        if case == "dtrace":
            DTRACE.configure(None)
    assert CW.ctu_writes["native"] == 0
    assert CW.ctu_writes["python"] >= 2 * _n_ctus(ecfg)


def test_lmcs_slice_falls_back_to_python():
    """A slice with LMCS (SyntaxCoder.reshape set) goes to the Python
    writer even for a CTU that carries the search's record."""
    ecfg = EncoderConfig(width=64, height=64, qp=32, device="cpu",
                         dual_tree=True)
    coder, ps = _coder(ecfg, 32)
    assert CW.covers(coder, ps)
    coder, ps = _coder(ecfg, 32)
    coder.reshape = object()
    root = _TreeGen(np.random.RandomState(3), coder,
                    PictureState(64, 64, 10), set()).ctu(0, 0)
    root.native_rec = _record(root, True)
    enc = CabacEncoder(BitWriter())
    enc.init_ctx(32, 2)
    CW.reset_ctu_writes()
    coder.encode_ctu(enc, ps, root)
    assert CW.ctu_writes == {"native": 0, "python": 1}


def test_inter_slices_fall_back_to_python(monkeypatch):
    """Random access: the I picture's CTUs go native, every CTU of an
    inter slice through the Python writer."""
    paths = []
    orig = CS.SyntaxCoder.encode_ctu

    def spy(coder, enc, ps, node):
        before = dict(CW.ctu_writes)
        orig(coder, enc, ps, node)
        path = "native" if CW.ctu_writes["native"] > before["native"] \
            else "python"
        paths.append((coder.is_intra_slice, path))
    monkeypatch.setattr(CS.SyntaxCoder, "encode_ctu", spy)
    ecfg = dataclasses.replace(_cli_config(128, 64, 32), intra_period=0,
                               gop_size=2, mctf=False)
    stream = IntraEncoder(ecfg).encode_sequence(_pictures(3, 128, 64))
    assert {p for intra, p in paths if intra} == {"native"}
    assert {p for intra, p in paths if not intra} == {"python"}
    assert len(decode_stream(stream)) == 3


# ---- random trees: each covered tool ---------------------------------------

def _coder(ecfg, qp, dq=False, sdh=False, qg_subdiv=None):
    enc = IntraEncoder(ecfg)
    sps, pps = enc.sps, copy.copy(enc.pps)
    sh = SliceHeader()
    sh.slice_qp = qp
    sh.slice_type = 2
    sh.dep_quant_used = 1 if dq else 0
    sh.sign_data_hiding_used = 1 if sdh else 0
    sh.ph = PictureHeader()
    if qg_subdiv is not None:
        pps.cu_qp_delta_enabled = 1
        sh.ph.cu_qp_delta_subdiv_intra = qg_subdiv
    coder = CS.SyntaxCoder(sps, pps, sh, QpState(sps, pps, qp, sh=sh))
    ps = PictureState(ecfg.width, ecfg.height, ecfg.bit_depth)
    coder.attach_motion(ps)
    return coder, ps


class _TreeGen:
    """Random coding trees in coding order, with the CU fields each tool
    signals; marks a scratch PictureState as the writers will, so that
    MRL CUs pick a mode of the MPM list the writers derive."""

    def __init__(self, rng, coder, ps, tools):
        self.rng, self.coder, self.ps, self.tools = rng, coder, ps, tools
        self.used = dict.fromkeys(("mtt", "mip", "mrl", "isp", "lfnst",
                                   "jccr"), 0)

    def coeffs(self, w, h, dense=0.3):
        """A block with a nonzero: spread over the coded region, in the
        low frequencies only (LFNST's last-position rules), or DC."""
        r = self.rng
        c = np.zeros((h, w), np.int32)
        kind = r.rand()
        if kind < 0.15:
            c[0, 0] = r.choice([-3, -1, 1, 2, 40])
            return c
        zw, zh = min(32, w), min(32, h)
        if kind < 0.45:
            zw, zh = min(4, w), min(4, h)
        mask = r.rand(zh, zw) < dense * r.rand()
        vals = r.randint(1, 4, (zh, zw)) * r.choice([-1, 1], (zh, zw))
        big = r.rand(zh, zw) < 0.03
        vals[big] *= r.randint(5, 400)
        c[:zh, :zw] = np.where(mask, vals, 0)
        if not c.any():
            c[r.randint(zh), r.randint(zw)] = r.choice([-2, 1, 3])
        return c

    def maybe(self, w, h, p=0.6):
        return self.coeffs(w, h) if self.rng.rand() < p else None

    def tree(self, x, y, w, h, part, depth=0):
        r, ps, sps = self.rng, self.ps, self.coder.sps
        ctree = part.tree_type == CS.CHROMA_TREE
        tidx = 2 if ctree else self.coder.tree_idx
        can = CS.split_options_full(ps, x, y, w, h, part, sps, tidx)
        splits = [s for s in range(1, 6) if can[s]
                  and not (part.mode_type == CS.MODE_ALL
                           and CS.signal_mode_cons(w, h, s, part.mode_type,
                                                   True) != CS.LDT_INHERIT)]
        if can[0] and (not splits or r.rand() < 0.25 + 0.2 * depth):
            split = CS.NO_SPLIT
        else:
            split = splits[r.randint(len(splits))]
        self.used["mtt"] += split not in (CS.NO_SPLIT, CS.QT_SPLIT)
        node = CS.TreeNode(x, y, max(w, h), part.qt_depth, w=w, h=h,
                           part=part, split_mode=split,
                           split=split != CS.NO_SPLIT)
        if split == CS.NO_SPLIT:
            node.cu = (self.chroma_cu if ctree else self.cu)(x, y, w, h,
                                                             part)
            return node
        impl = CS.implicit_split(ps, x, y, w, h, part, sps, tidx)
        for idx, (cx, cy, cw, ch) in enumerate(
                CS.split_geometry(split, x, y, w, h)):
            if cx < ps.w and cy < ps.h:
                node.children.append(self.tree(
                    cx, cy, cw, ch, part.child(split, idx, split == impl),
                    depth + 1))
        return node

    def chroma_dir(self, cu):
        r = self.rng
        k = r.randint(6 if self.coder.sps.cclm and cu.cclm_allowed else 3)
        if k == 0:
            return CS.DM_CHROMA
        if k <= 2:
            return CS.chroma_cand_modes(CS.dm_luma_mode(cu))[r.randint(4)]
        return (81, 82, 83)[k - 3]

    def chroma(self, cu, w, h):
        r, t = self.rng, self.tools
        if "jccr" in t and r.rand() < 0.4:
            self.used["jccr"] += 1
            cu.joint_cbcr = int(r.randint(1, 4))
            if cu.joint_cbcr in (2, 3):
                cu.coeff_cb = self.coeffs(w >> 1, h >> 1)
            else:
                cu.coeff_cr = self.coeffs(w >> 1, h >> 1)
        else:
            cu.coeff_cb = self.maybe(w >> 1, h >> 1, 0.5)
            cu.coeff_cr = self.maybe(w >> 1, h >> 1, 0.5)

    def cu(self, x, y, w, h, part):
        r, t, coder, ps = self.rng, self.tools, self.coder, self.ps
        lo = part.tree_type == CS.TREE_L
        cu = CS.CuData(x, y, w, h, luma_only=lo)
        cu.recon_done = True
        cu.luma_mode = int(r.randint(67))
        if "mip" in t and r.rand() < 0.3:
            cu.mip_flag = True
            cu.mip_transposed = bool(r.randint(2))
            cu.luma_mode = int(r.randint(num_mip_modes(w, h)))
        elif "mrl" in t and y % coder.ctu_size and r.rand() < 0.3:
            cu.ref_line = int(r.randint(1, 3))
            mpm = CS.get_intra_mpms(ps, x, y, w, h, coder.ctu_size)
            cu.luma_mode = mpm[r.randint(1, 6)]
        elif "isp" in t and coder._isp_coded(cu) and r.rand() < 0.4:
            cu.isp_mode = int(r.randint(1, 3))
            parts = CS.isp_partitions(w, h, cu.isp_mode)
            cu.isp_coeffs = [self.maybe(pw, ph, 0.5)
                             for (_, _, pw, ph) in parts]
            if all(c is None for c in cu.isp_coeffs[:-1]):
                cu.isp_coeffs[-1] = self.coeffs(parts[-1][2], parts[-1][3])
        if not cu.isp_mode:
            cu.coeff_y = self.maybe(w, h)
        if "lfnst" in t:
            cu.lfnst_idx = int(r.randint(3))
        self.used["mip"] += cu.mip_flag
        self.used["mrl"] += cu.ref_line > 0
        self.used["isp"] += cu.isp_mode > 0
        self.used["lfnst"] += cu.lfnst_idx > 0
        if not lo:
            self.chroma(cu, w, h)
            cu.chroma_dir = self.chroma_dir(cu)
        ps.mark_cu(x, y, w, h, part.qt_depth, CS.dm_luma_mode(cu),
                   is_mip=cu.mip_flag, with_chroma=not lo)
        return cu

    def chroma_cu(self, x, y, w, h, part):
        r = self.rng
        cu = CS.CuData(x, y, w, h)
        cu.recon_done = True
        cu.chroma_only = True
        cu.luma_mode = int(r.randint(67))
        cu.cclm_allowed = bool(r.rand() < 0.7)
        if "lfnst" in self.tools:
            cu.lfnst_idx = int(r.randint(3))
        self.chroma(cu, w, h)
        cu.chroma_dir = self.chroma_dir(cu)
        self.ps.mark_chroma(x, y, w, h, part.qt_depth)
        return cu

    def ctu(self, cx, cy):
        ctu, coder, ps = self.coder.ctu_size, self.coder, self.ps
        if not coder.dual_tree_intra:
            return self.tree(cx, cy, ctu, ctu, CS.PartInfo())
        root = CS.TreeNode(cx, cy, ctu, 0, w=ctu, h=ctu, part=CS.PartInfo())
        unit, qtd = min(64, ctu), 1 if ctu > 64 else 0
        for uy in range(cy, cy + ctu, unit):
            for ux in range(cx, cx + ctu, unit):
                if ux >= ps.w or uy >= ps.h:
                    continue
                for tt in (CS.TREE_L, CS.CHROMA_TREE):
                    root.children.append(self.tree(
                        ux, uy, unit, unit,
                        CS.PartInfo(qt_depth=qtd, subdiv=2 * qtd,
                                    mode_type=CS.MODE_INTRA, tree_type=tt)))
        return root


def _serialize(node, tree, coeff, chroma_tree=False):
    """The native search's record of a tree (ctusearch::serialize)."""
    tree.append(node.split_mode)
    if node.split_mode != CS.NO_SPLIT:
        for c in node.children:
            _serialize(c, tree, coeff, chroma_tree)
        return
    cu = node.cu

    def blk(c):
        tree.append(0 if c is None else 1)

    def put(c):
        if c is not None:
            coeff.extend(c.ravel().tolist())
    if chroma_tree:
        tree += [cu.luma_mode, cu.chroma_dir, int(cu.cclm_allowed),
                 cu.lfnst_idx, cu.joint_cbcr]
        blk(cu.coeff_cb), blk(cu.coeff_cr), put(cu.coeff_cb), put(cu.coeff_cr)
        return
    tree += [cu.luma_mode, int(cu.mip_flag), int(cu.mip_transposed),
             cu.ref_line, cu.lfnst_idx, cu.joint_cbcr, cu.isp_mode]
    if cu.isp_mode:
        for c in cu.isp_coeffs:
            blk(c)
            put(c)
    else:
        blk(cu.coeff_y)
        put(cu.coeff_y)
    if not cu.luma_only:
        tree.append(cu.chroma_dir)
        blk(cu.coeff_cb), blk(cu.coeff_cr), put(cu.coeff_cb), put(cu.coeff_cr)


def _record(root, dual):
    tree, coeff = [], []
    if dual:
        for k, c in enumerate(root.children):
            _serialize(c, tree, coeff, chroma_tree=k % 2 == 1)
    else:
        _serialize(root, tree, coeff)
    return CW.Record(np.asarray(tree, np.int32),
                     np.asarray(coeff, np.int32))


# tool -> (encoder options, writer options, what the trees must hold);
# each tree mixes the tool with the rest of the set it runs in
FUZZ = {
    "single_tree_qt": (dict(dual_tree=False), {}, None),
    "dual_tree": (dict(dual_tree=True), {}, None),
    "mtt": (dict(dual_tree=True, max_mtt_depth=3), {}, "mtt"),
    "mtt_single_tree": (dict(dual_tree=False, max_mtt_depth=2), {}, "mtt"),
    "ctu128": (dict(ctu_size=128, max_mtt_depth=2), {}, "mtt"),
    "mip": (dict(mip=True, max_mtt_depth=1), {}, "mip"),
    "mrl": (dict(mrl=True, dual_tree=False), {}, "mrl"),
    "isp": (dict(isp=True, max_mtt_depth=1), {}, "isp"),
    "lfnst": (dict(lfnst=True, isp=True, mip=True, max_mtt_depth=1), {},
              "lfnst"),
    "jccr": (dict(jccr=True), {}, "jccr"),
    "dep_quant": (dict(dep_quant=True), dict(dq=True), None),
    "sign_hiding": (dict(sign_data_hiding=True), dict(sdh=True), None),
    "cu_qp_delta": (dict(max_mtt_depth=2), dict(qg_subdiv=2), None),
    "cu_qp_delta_single_tree": (dict(dual_tree=False), dict(qg_subdiv=4),
                                None),
}


@pytest.mark.parametrize("tool", sorted(FUZZ))
def test_native_writer_random_trees(tool):
    enc_opts, wr_opts, used = FUZZ[tool]
    w, h = (256, 192) if enc_opts.get("ctu_size") == 128 else (200, 120)
    opts = dict(dict(ctu_size=64, dual_tree=True, cclm=True,
                     mts_implicit=True), **enc_opts)
    ecfg = EncoderConfig(width=w, height=h, qp=32, device="cpu", **opts)
    tools = {t for t in ("mip", "mrl", "isp", "lfnst", "jccr")
             if opts.get(t)}
    rng = np.random.RandomState(sorted(FUZZ).index(tool) + 11)
    coder, ps = _coder(ecfg, 32, **wr_opts)
    assert CW.covers(coder, ps)
    assert coder.dq == bool(wr_opts.get("dq"))
    assert coder.sdh == bool(wr_opts.get("sdh"))
    assert coder.use_dqp == ("qg_subdiv" in wr_opts)
    gen = _TreeGen(rng, coder, PictureState(w, h, 10), tools)
    enc = CabacEncoder(BitWriter())
    enc.init_ctx(32, 2)
    ctu = ecfg.ctu_size
    twin = _Twin()
    for cy in range(0, h, ctu):
        for cx in range(0, w, ctu):
            root = gen.ctu(cx, cy)
            root.native_rec = _record(root, coder.dual_tree_intra)
            if coder.use_dqp:
                root.native_rec.qp = int(rng.randint(22, 43))
                _stamp_qp(root, root.native_rec.qp)
            twin(coder, enc, ps, root)
    assert twin.checked == -(-w // ctu) * -(-h // ctu)
    if used is not None:
        assert gen.used[used] > 0, gen.used


def _stamp_qp(node, qp):
    """encoder/intra_encoder._set_tree_qp's stamp on every CU."""
    if node.cu is not None:
        node.cu.qp = qp
    for c in node.children:
        _stamp_qp(c, qp)


def test_prof_report_counts_ctu_writes(capsys):
    from vvenc_tpu_torch.utils.profiler import Profiler
    CW.reset_ctu_writes()
    for path in ("native", "native", "python"):
        CW.count(path)
    prof = Profiler(True)
    with prof.section("slice.ctu_encode"):
        pass
    assert prof.report().splitlines()[-1] == "CTU writes: native 2, python 1"
