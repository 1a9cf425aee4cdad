"""The native CTU syntax writer for intra slices (ctu_writer.cpp).

SyntaxCoder.encode_ctu hands a CTU to write_ctu when covers() held for
its picture and the CTU's tree carries the native search's record
(TreeNode.native_rec, a Record); otherwise the Python writer codes it.
One ctypes call a CTU codes every bin of the CTU's syntax and leaves the
contexts, the arithmetic state, the PictureState maps, the quantization
group state and the motion field as the Python writer leaves them; ctypes
releases the GIL for the call, so the frame-parallel pool's threads write
their pictures at once.  The Python writer stays the specification that
tests/test_torch_native_writer.py holds this one to.

ctu_writes counts the CTUs each path wrote (the pool writes from several
threads, so the count takes a lock); PROF.report() and chip_smoke.py
print it.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from . import _LIB, build_library

_SRC = pathlib.Path(__file__).resolve().with_name("ctu_writer.cpp")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

ctu_writes = {"native": 0, "python": 0}
_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
_WLIB = None          # the loaded library; False once it failed to build
BUILD_ERROR = None


def reset_ctu_writes() -> None:
    with _COUNT_LOCK:
        for k in ctu_writes:
            ctu_writes[k] = 0


def count(path: str) -> None:
    """One CTU written by `path` ("native" or "python")."""
    with _COUNT_LOCK:
        ctu_writes[path] += 1


class Record:
    """The native search's decision of one CTU, as it serialized it:
    split tokens and CU fields in coding order (tree) and the CUs'
    coefficient blocks (coeff), both int32.  qp is the CTU QP that
    encoder/intra_encoder._set_tree_qp stamps on every CU (-1: none)."""

    __slots__ = ("tree", "coeff", "qp")

    def __init__(self, tree: np.ndarray, coeff: np.ndarray):
        self.tree = tree
        self.coeff = coeff
        self.qp = -1


def _build():
    global BUILD_ERROR
    lib, BUILD_ERROR = build_library(_SRC, _FLAGS)
    if lib is None:
        return None
    lib.vtw_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vtw_init.restype = None
    lib.vtw_write_ctu.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int])
    lib.vtw_write_ctu.restype = ctypes.c_int
    assert lib.vtw_ctu_param_index() == _P_CTU_X
    from ..bitstream import ctx_tables as ct
    offs = np.asarray([ct.CTX_SETS[n](0) for n in (
        "SplitFlag", "SplitQtFlag", "SplitHvFlag", "Split12Flag",
        "IntraLumaMpmFlag", "IntraLumaPlanarFlag", "IntraChromaPredMode",
        "CclmModeFlag", "CclmModeIdx", "QtCbfLuma", "QtCbfCb", "QtCbfCr",
        "DeltaQP", "MipFlag", "MultiRefLineIdx", "LFNSTIdx",
        "JointCbCrFlag", "ISPMode")], dtype=np.int32)
    lib.vtw_init(offs.ctypes.data,
                 ctypes.cast(_LIB.vte_write_residual, ctypes.c_void_p))
    return lib


def _lib():
    global _WLIB
    if _WLIB is None:
        with _LOAD_LOCK:
            if _WLIB is None:
                _WLIB = (_build() if _LIB is not None else None) or False
    return _WLIB or None


def covers(coder, ps) -> bool:
    """True when the writer codes every syntax element that this slice's
    SPS, PPS and slice header enable: an intra slice of one tile without
    transform skip, BDPCM, IBC, explicit MTS or LMCS, and no syntax
    trace.  Decided once a picture (SyntaxCoder keeps the answer)."""
    from ..utils.dtrace import DTRACE
    return (coder.is_intra_slice and not coder.ts_en
            and not coder.bdpcm_en and not coder.ibc_en
            and coder.reshape is None and not coder.sps.mts_intra
            and ps.tile_map is None and not DTRACE.enabled
            and _lib() is not None)


# params layout (ctu_writer.cpp enum P): 37 of the picture, 3 of the CTU
_P_CTU_X = 37


def _prepare(coder, ps):
    """Per-picture arrays: the parameters and the map addresses."""
    sps = coder.sps
    mf = coder.mf
    params = np.zeros(_P_CTU_X + 3, np.int32)
    params[:_P_CTU_X] = [
        ps.w, ps.h, coder.ctu_size, ps.coded_luma.shape[1],
        ps.coded_luma.shape[0], ps.coded_chroma.shape[1],
        ps.coded_chroma.shape[0], mf.uw if mf is not None else 0,
        mf.uh if mf is not None else 0,
        *sps.min_qt_size[:3], *sps.max_mtt_depth[:3],
        *sps.max_bt_size[:3], *sps.max_tt_size[:3],
        sps.log2_min_cb_size, coder.tree_idx,
        1 if coder.dual_tree_intra else 0, 1 if coder.use_dqp else 0,
        coder.qg_subdiv, coder.qp.qp_bd_offset, coder.qp.slice_qp,
        1 if coder.dq else 0, 1 if coder.sdh else 0,
        1 if coder.jccr else 0, 1 if sps.cclm else 0,
        1 if sps.mip else 0, 1 if sps.mrl else 0,
        1 if getattr(sps, "isp", 0) else 0, 1 if sps.lfnst else 0,
        sps.max_tb_size]

    def addr(a, itemsize):
        # the writer reads 1-byte flags and int32 values in C order
        if a.itemsize != itemsize or not a.flags.c_contiguous:
            raise TypeError(f"map of {a.dtype} is not what the native "
                            "writer reads")
        return a.ctypes.data
    ptrs = [addr(a, n) for a, n in (
        (ps.coded_luma, 1), (ps.intra_mode, 4), (ps.is_intra, 1),
        (ps.is_mip, 1), (ps.cu_w, 4), (ps.cu_h, 4), (ps.cu_x, 4),
        (ps.cu_y, 4), (ps.qt_depth, 4), (ps.qp_map, 4),
        (ps.coded_chroma, 1), (ps.ccu_w, 4), (ps.ccu_h, 4),
        (ps.cqt_depth, 4))]
    ptrs += ([addr(a, 1) for a in (mf.valid, mf.skipf, mf.isaff,
                                   mf.aff_valid)]
             if mf is not None else [0] * 4)
    return ps, params, np.asarray(ptrs, np.int64)


_TLS = threading.local()


def _bufs(ctu: int):
    n = ctu * ctu * 12 + (1 << 17)
    b = getattr(_TLS, "bufs", None)
    if b is None or len(b[0]) < n:
        b = (np.empty(n, np.uint8), np.empty(5, np.int64),
             np.empty(6, np.int32), np.empty(8, np.int32))
        _TLS.bufs = b
    return b


def write_ctu(coder, enc, ps, node) -> None:
    """Code one CTU of an intra slice natively (SyntaxCoder.encode_ctu's
    contract): bins into enc, maps into ps, group state into coder."""
    prep = coder._native_prep
    if prep is None or prep[0] is not ps:
        prep = coder._native_prep = _prepare(coder, ps)
    _, params, maps = prep
    rec = node.native_rec
    params[_P_CTU_X] = node.x
    params[_P_CTU_X + 1] = node.y
    params[_P_CTU_X + 2] = rec.qp
    out, st, qg, l64 = _bufs(coder.ctu_size)
    st[0] = enc.low
    st[1] = enc.range
    st[2] = enc.buffered_byte
    st[3] = enc.num_buffered_bytes
    st[4] = enc.bits_left
    qg[0] = coder.cur_qp
    qg[1] = coder.qg_start
    qg[2] = coder.dqp_coded
    qg[3] = coder.qg_pred_qp
    qg[4] = -1 if coder._qg_delta_at is None else coder._qg_delta_at
    qg[5] = coder.qp.qp_y
    ctx = enc.ctx
    n = _WLIB.vtw_write_ctu(
        params.ctypes.data, rec.tree.ctypes.data, len(rec.tree),
        rec.coeff.ctypes.data, len(rec.coeff), maps.ctypes.data,
        ctx.state0.ctypes.data, ctx.state1.ctypes.data,
        ctx.rate0.ctypes.data, ctx.rate1.ctypes.data, st.ctypes.data,
        qg.ctypes.data, l64.ctypes.data, out.ctypes.data, len(out))
    if n < 0:
        raise RuntimeError(f"native CTU writer failed ({n}) at CTU "
                           f"({node.x}, {node.y})")
    enc.low = int(st[0])
    enc.range = int(st[1])
    enc.buffered_byte = int(st[2])
    enc.num_buffered_bytes = int(st[3])
    enc.bits_left = int(st[4])
    coder.cur_qp = int(qg[0])
    coder.qg_start = bool(qg[1])
    coder.dqp_coded = bool(qg[2])
    coder.qg_pred_qp = int(qg[3])
    coder._qg_delta_at = None if qg[4] < 0 else int(qg[4])
    coder.qp.qp_y = int(qg[5])
    if coder.dual_tree_intra:
        # the 64-units' luma records (CU::checkCCLMAllowed's inputs); the
        # root's children are each unit's luma tree, then its chroma tree
        for k, unit in enumerate(node.children[::2]):
            coder.luma64[(unit.x, unit.y)] = [int(l64[2 * k]),
                                              bool(l64[2 * k + 1])]
    if n:
        bw = enc.bw
        data = out[:n].tobytes()
        if bw.is_byte_aligned():
            bw.append_bytes(data)
        else:
            for b in data:
                bw.write(b, 8)
