"""The in-loop deblocking filter of one picture in native code
(deblock.cpp), for the encoder.

deblock_picture takes codec/deblock.py deblock_picture's arguments and
gives its samples: it flattens the CU list into int32 rows (the fields
that _BsMaps and the edge walk read, with the reference indices resolved
through ref_pocs), tabulates chroma_qp_fn over the QPs of qp_map, and
filters the int32 planes of `rec` in place in one ctypes call, which
releases the GIL, so the frame-parallel pool's threads deblock their
pictures at once.  A picture the native filter does not cover goes to the
Python model whole: a CU list with an IBC CU, planes that are not
C-contiguous int32, a bit depth outside 8..16, an input whose index the
Python model would reject, or VVENC_TPU_NATIVE=0.  The Python model stays
the specification that tests/test_torch_native_deblock.py holds this one
to, and the port's decoder keeps it.

PROF counts the pictures (and CTU-row bands) each path filtered under
`native.deblock.pictures`, "native" or "python".
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from . import build_library, enabled
from ..utils.profiler import PROF

_SRC = pathlib.Path(__file__).resolve().with_name("deblock.cpp")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
COUNTER = "native.deblock.pictures"

_LOAD_LOCK = threading.Lock()
_DLIB = None          # the loaded library; False once it failed to build
BUILD_ERROR = None

# deblock.cpp's layouts: enum CF (a CU row), enum Flag, enum P
_CU_F, _TU_F, _SUB_F, _P_N = 25, 8, 8, 18
(_F_CHROMA_ONLY, _F_LUMA_ONLY, _F_INTER, _F_CIIP, _F_AFFINE, _F_SUB_MI,
 _F_CBF_Y, _F_CBF_CB, _F_CBF_CR, _F_MTB, _F_BDPCM_Y, _F_BDPCM_C) = \
    (1 << k for k in range(12))
_NO_CU = [0] * (_CU_F - 6)
# the widest QP range tabulated for the chroma mapping
_MAX_QP_SPAN = 1024


def _build():
    global BUILD_ERROR
    lib, BUILD_ERROR = build_library(_SRC, _FLAGS)
    if lib is None:
        return None
    lib.vtd_deblock_picture.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int] +
        [ctypes.c_void_p] * 5)
    lib.vtd_deblock_picture.restype = ctypes.c_int
    assert lib.vtd_cu_fields() == _CU_F and lib.vtd_params() == _P_N
    return lib


def _lib():
    global _DLIB
    if _DLIB is None:
        with _LOAD_LOCK:
            if _DLIB is None:
                _DLIB = _build() or False
    return _DLIB or None


class _Uncovered(Exception):
    pass


def _motion(mi_ref_idx, mi_mv, rp, out):
    """One prediction's two lists as _BsMaps reads them: per list a valid
    flag, the reference POC and the MV (zeros where the index does not
    resolve through ref_pocs)."""
    for li in (0, 1):
        ri = mi_ref_idx[li]
        if ri >= 0 and li < len(rp) and ri < len(rp[li]):
            out += (1, rp[li][ri], mi_mv[li][0], mi_mv[li][1])
        else:
            out += (0, 0, 0, 0)


def _flatten(cu_list, ref_pocs):
    """(CU rows, TU rows, per-4x4 motion rows) as int32 arrays."""
    from ..codec.ctu_syntax import isp_partitions, sbt_tu_rect
    rp = ref_pocs or [[], []]
    rows, tus, sub = [], [], []
    for cu in cu_list:
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        joint = getattr(cu, "joint_cbcr", 0)
        f = 0
        if getattr(cu, "coeff_cb", None) is not None:
            f |= _F_CBF_CB
        if getattr(cu, "coeff_cr", None) is not None:
            f |= _F_CBF_CR
        if getattr(cu, "bdpcm_c", 0):
            f |= _F_BDPCM_C
        if getattr(cu, "chroma_only", False):
            rows.append([x, y, w, h, f | _F_CHROMA_ONLY, joint] + _NO_CU)
            continue
        inter = getattr(cu, "is_inter", False)
        if inter and getattr(cu, "is_ibc", False):
            raise _Uncovered("IBC")
        if getattr(cu, "luma_only", False):
            f |= _F_LUMA_ONLY
        if getattr(cu, "coeff_y", None) is not None:
            f |= _F_CBF_Y
        if getattr(cu, "bdpcm_y", 0):
            f |= _F_BDPCM_Y
        if getattr(cu, "affine", False):
            f |= _F_AFFINE
        isp = getattr(cu, "isp_mode", 0)
        isp_w = isp_h = 0
        if isp:
            _, _, isp_w, isp_h = isp_partitions(w, h, isp)[0]
        sbt = getattr(cu, "sbt_idx", 0)
        sbt_pos = tx = ty = tw = th = 0
        if sbt:
            sbt_pos = cu.sbt_pos
            tx, ty, tw, th = sbt_tu_rect(cu)[:4]
        tu0 = ntu = 0
        mtb = getattr(cu, "mtb_tus", None)
        if mtb is not None:
            f |= _F_MTB
            tu0, ntu = len(tus) // _TU_F, len(mtb)
            for t in mtb:
                if len(t) != 10:
                    raise _Uncovered("max-TB TU record")
                tus += (t[0], t[1], t[2], t[3], t[4] is not None,
                        t[5] is not None, t[6] is not None, t[7])
        mot = [0] * 7
        sub0 = 0
        if inter:
            f |= _F_INTER
            if getattr(cu, "ciip", False):
                f |= _F_CIIP
            sub_mi = getattr(cu, "sub_mi", None)
            if sub_mi is not None:
                f |= _F_SUB_MI
                sub0 = len(sub) // _SUB_F
                for uy in range(y >> 2, (y + h) >> 2):
                    line = sub_mi[uy - (y >> 2)]
                    for ux in range(x >> 2, (x + w) >> 2):
                        mi = line[ux - (x >> 2)]
                        _motion(mi.ref_idx, mi.mv, rp, sub)
            else:
                m = []
                _motion(cu.ref_idx, cu.mv, rp, m)
                mot = [m[0] | m[4] << 1, *m[1:4], *m[5:8]]
        rows.append([x, y, w, h, f, joint, isp, isp_w, isp_h, sbt, sbt_pos,
                     tx, ty, tw, th, tu0, ntu, *mot, sub0])
    return (np.asarray(rows, np.int32).reshape(-1, _CU_F),
            np.asarray(tus, np.int32), np.asarray(sub, np.int32))


def _plane(a):
    if not (isinstance(a, np.ndarray) and a.dtype == np.int32
            and a.ndim == 2 and a.flags.c_contiguous and a.flags.writeable):
        raise _Uncovered("plane layout")
    return a


_EMPTY = np.zeros(1, np.int32)


def _addr(a):
    return a.ctypes.data if a.size else _EMPTY.ctypes.data


def _native(rec, cu_list, qp_luma, qp_cb, qp_cr, ctu_size, bit_depth,
            ref_pocs, is_b, qp_map, chroma_qp_fn, y_band) -> bool:
    """True when the native filter deblocked the picture."""
    if not enabled():
        return False
    lib = _lib()
    if lib is None:
        return False
    try:
        y, cb, cr = _plane(rec[0]), _plane(rec[1]), _plane(rec[2])
        if cb.shape != cr.shape or not 8 <= bit_depth <= 16 \
                or ctu_size <= 0:
            raise _Uncovered("picture format")
        cus, tus, sub = _flatten(cu_list, ref_pocs)
        prm = np.zeros(_P_N, np.int32)
        prm[:10] = (y.shape[1], y.shape[0], cb.shape[1], cb.shape[0],
                    ctu_size, bit_depth, 1 if is_b else 0, qp_luma, qp_cb,
                    qp_cr)
        qmap = ctab = _EMPTY
        if qp_map is not None:
            if chroma_qp_fn is None:
                raise _Uncovered("no chroma QP mapping")
            qmap = np.ascontiguousarray(qp_map, np.int32)
            lo, hi = int(qmap.min()), int(qmap.max())
            if hi - lo >= _MAX_QP_SPAN:
                raise _Uncovered("QP range")
            ctab = np.asarray([chroma_qp_fn(v, comp, joint)
                               for comp in (1, 2) for joint in (False, True)
                               for v in range(lo, hi + 1)], np.int32)
            prm[10:15] = (1, qmap.shape[1], qmap.shape[0], lo, hi - lo + 1)
        if y_band is not None:
            prm[15:18] = (1, y_band[0], y_band[1])
    except (_Uncovered, OverflowError):
        return False
    n = lib.vtd_deblock_picture(
        prm.ctypes.data, _addr(cus), len(cus), _addr(tus),
        len(tus) // _TU_F, _addr(sub), len(sub) // _SUB_F, qmap.ctypes.data,
        ctab.ctypes.data, y.ctypes.data, cb.ctypes.data, cr.ctypes.data)
    return n >= 0


def deblock_picture(rec, cu_list, qp_luma: int, qp_cb: int, qp_cr: int,
                    ctu_size: int, bit_depth: int = 10, ref_pocs=None,
                    is_b: bool = False, qp_map=None, chroma_qp_fn=None,
                    y_band=None) -> None:
    """codec/deblock.py deblock_picture, in native code where it covers
    the picture (the module's docstring), else in Python."""
    if _native(rec, cu_list, qp_luma, qp_cb, qp_cr, ctu_size, bit_depth,
               ref_pocs, is_b, qp_map, chroma_qp_fn, y_band):
        PROF.count(COUNTER, "native")
        return
    from ..codec.deblock import deblock_picture as python_deblock
    python_deblock(rec, cu_list, qp_luma, qp_cb, qp_cr, ctu_size, bit_depth,
                   ref_pocs=ref_pocs, is_b=is_b, qp_map=qp_map,
                   chroma_qp_fn=chroma_qp_fn, y_band=y_band)
    PROF.count(COUNTER, "python")
