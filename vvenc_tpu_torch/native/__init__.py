"""Native (C++) host-side entropy kernels, loaded via ctypes.

The reference encoder's host runtime is C++ (BinEncoder estimator, RDOQ,
residual syntax); this package provides the same for vvenc_tpu_torch: a
lazily g++-compiled shared library, built from the repository's
native/entropy.cpp into vvenc_tpu_torch/_build/native/ with the same flags
as the JAX package's binding, with bit-exact ports of the Python
reference paths.  The Python implementations remain the golden
reference; tests/test_native.py enforces exact equivalence, and the
encoder transparently dispatches to the native path when available.

Set VVENC_TPU_NATIVE=0 to force the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

# array arguments are passed as raw addresses (ctypes.c_void_p): the
# wrappers guarantee dtype + C-contiguity via ascontiguousarray, and the
# int address path is ~3x cheaper per argument than data_as/ndpointer
_PI32 = _PU16 = _PU8 = _PI64 = ctypes.c_void_p

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "entropy.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build" / "native"


BUILD_ERROR = None  # the compiler's message when the library did not build


def enabled() -> bool:
    """False under VVENC_TPU_NATIVE=0: every native path stays off."""
    return os.environ.get("VVENC_TPU_NATIVE", "1") != "0"


def build_library(src: pathlib.Path, *flag_sets):
    """g++ `src` into _BUILD_DIR/<stem>-<hash>.so, named by the hash of
    the source and the first flag set, trying each set in turn (the later
    ones are portable fallbacks), and load it.  The build lands through
    an atomic rename, so processes building at once agree; callers that
    share a process hold a lock.  Returns (the library, None) or (None,
    the compiler's or loader's message)."""
    code = src.read_bytes()
    tag = hashlib.sha256(code + " ".join(flag_sets[0]).encode()) \
        .hexdigest()[:16]
    so = _BUILD_DIR / f"{src.stem}-{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
        err = None
        for flags in flag_sets:
            try:
                subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
                break
            except subprocess.CalledProcessError as exc:
                err = exc.stderr.decode(errors="replace")[-4000:]
            except OSError as exc:
                err = str(exc)
        else:
            return None, err
    try:
        return ctypes.CDLL(str(so)), None
    except OSError as exc:
        return None, str(exc)


def _load():
    global BUILD_ERROR
    if not enabled() or not _SRC.exists():
        return None
    # -march=native: the kernels are built on (and only run on) this
    # host; the matmul-style transform loops vectorize to AVX2/AVX-512.
    # -ffp-contract=off: keep double arithmetic bit-exact against the
    # Python golden models (FMA contraction would fork RDOQ/estimator
    # cost near-ties, which are decision-visible).
    # -include string: native/entropy.cpp uses std::string without
    # including <string>, which g++ 13's libstdc++ no longer pulls in
    # through the headers the file does include.
    # The second set is the portable fallback (e.g. -march=native
    # unsupported).
    lib, BUILD_ERROR = build_library(
        _SRC, ["-O3", "-march=native", "-ffp-contract=off", "-shared",
               "-fPIC", "-std=c++17", "-include", "string"],
        ["-O3", "-shared", "-fPIC", "-std=c++17", "-include", "string"])
    if lib is None:
        return None

    lib.vte_init.argtypes = [_PI32,
                             ctypes.POINTER(ctypes.c_uint32)]
    lib.vte_init.restype = None
    lib.vte_est_residual.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _PU16, _PU16,
        _PU8, _PU8]
    lib.vte_est_residual.restype = ctypes.c_int64
    lib.vte_rdoq.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int,
        _PU16, _PU16,
        _PI32]
    lib.vte_rdoq.restype = None
    lib.vte_write_residual.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _PU16, _PU16,
        _PU8, _PU8,
        _PI64, _PU8]
    lib.vte_write_residual.restype = ctypes.c_int

    lib.vte_set_trmat.argtypes = [ctypes.c_int, ctypes.c_int,
                                  _PI32]
    lib.vte_set_trmat.restype = None
    lib.vte_tq_trial.argtypes = [
        _PI32, _PI32,
        _PI32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        _PU16, _PU16,
        _PI32, _PI32,
        _PI64, ctypes.c_int]
    lib.vte_tq_trial.restype = ctypes.c_int
    lib.vte_tq_quant.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        _PU16, _PU16,
        _PI32, ctypes.c_int]
    lib.vte_tq_quant.restype = ctypes.c_int
    lib.vte_predict_intra.argtypes = [
        _PI32, ctypes.c_int,
        _PI32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _PI32]
    lib.vte_predict_intra.restype = None
    lib.vte_predict_modes.argtypes = [
        _PI32, ctypes.c_int,
        _PI32, ctypes.c_int,
        _PI32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _PI32]
    lib.vte_predict_modes.restype = None
    lib.vte_satd_modes.argtypes = [
        _PI32, _PI32, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PI64]
    lib.vte_satd_modes.restype = None
    lib.vte_presel_satd.argtypes = [
        _PI32, ctypes.c_int, _PI32, ctypes.c_int, _PI32, _PI32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _PI64]
    lib.vte_presel_satd.restype = None
    lib.vte_build_refs.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _PU8, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _PI32, _PI32]
    lib.vte_build_refs.restype = None
    for nm in ("vte_fwd_transform", "vte_inv_transform"):
        getattr(lib, nm).argtypes = [
            _PI32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _PI32]
        getattr(lib, nm).restype = None
    lib.vte_dequant.argtypes = [_PI32, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _PI32]
    lib.vte_dequant.restype = None
    lib.vte_cclm_predict.argtypes = [
        _PI32, _PI32, _PI32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _PU8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _PI32, ctypes.c_int, _PI32]
    lib.vte_cclm_predict.restype = None

    # install context-set bases + the estimator frac-bits table
    from ..bitstream import ctx_tables as ct
    from ..bitstream.cabac import FRAC_BITS_TABLE
    bases = []
    bases += [s.offset for s in ct.SIG_FLAG]          # 6
    bases += [s.offset for s in ct.PAR_FLAG]          # 2
    bases += [s.offset for s in ct.GTX_FLAG]          # 4
    bases += [s.offset for s in ct.LAST_X]            # 2
    bases += [s.offset for s in ct.LAST_Y]            # 2
    bases += [s.offset for s in ct.SIG_COEFF_GROUP]   # 2
    bases_np = np.asarray(bases, dtype=np.int32)
    frac_np = np.ascontiguousarray(FRAC_BITS_TABLE, dtype=np.uint32)
    lib.vte_init(bases_np.ctypes.data,
                 frac_np.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))

    # register the transform ROM (single-sourced from ops/transforms.py)
    from ..ops import transforms as T
    for n in (2, 4, 8, 16, 32, 64):
        m = np.ascontiguousarray(T.tr_matrix(n, T.DCT2), dtype=np.int32)
        lib.vte_set_trmat(T.DCT2, n, m.ctypes.data)
    for tt in (T.DST7, T.DCT8):
        for n in (4, 8, 16, 32):
            m = np.ascontiguousarray(T.tr_matrix(n, tt), dtype=np.int32)
            lib.vte_set_trmat(tt, n, m.ctypes.data)

    # register the MIP weight ROM (single-sourced from ops/mip.py's npz)
    from ..ops.mip import MIP_MATRIX
    lib.vte_mip_init.argtypes = [_PI32] * 3
    lib.vte_predict_mip.argtypes = [_PI32, _PI32] + [ctypes.c_int] * 5 \
        + [_PI32]
    lib.vte_predict_mip_all.argtypes = [_PI32, _PI32] + [ctypes.c_int] * 3 \
        + [_PI32]
    mw = [np.ascontiguousarray(MIP_MATRIX[k].reshape(-1), dtype=np.int32)
          for k in range(3)]
    lib.vte_mip_init(mw[0].ctypes.data, mw[1].ctypes.data,
                     mw[2].ctypes.data)

    # register the MCTF fractional-filter ROM (encoder/mctf.py tables)
    from ..encoder.mctf import MCTF_FILTER8, MCTF_FILTER4
    lib.vte_mctf_init.argtypes = [_PI32, _PI32]
    mf8 = np.ascontiguousarray(MCTF_FILTER8, dtype=np.int32)
    mf4 = np.ascontiguousarray(MCTF_FILTER4, dtype=np.int32)
    lib.vte_mctf_init(mf8.ctypes.data, mf4.ctypes.data)

    # register the LFNST ROM (single-sourced from ops/lfnst.py's npz)
    from ..ops.lfnst import FWD4, FWD8, LFNST_LUT
    lib.vte_lfnst_init.argtypes = [_PI32] * 3
    f8 = np.ascontiguousarray(FWD8.reshape(-1), dtype=np.int32)
    f4 = np.ascontiguousarray(FWD4.reshape(-1), dtype=np.int32)
    lut = np.ascontiguousarray(LFNST_LUT, dtype=np.int32)
    lib.vte_lfnst_init(f8.ctypes.data, f4.ctypes.data, lut.ctypes.data)
    return lib


_LIB = _load()


def available() -> bool:
    return _LIB is not None


# raw-address helpers: a.ctypes.data is the cheapest per-argument
# marshaling path (argtypes declare c_void_p)
def _u16p(a):
    return a.ctypes.data


def _u8p(a):
    return a.ctypes.data


def _i32p(a):
    return a.ctypes.data


def est_residual(coeff: np.ndarray, is_luma: bool, dep_quant: bool,
                 ctx, sign_hiding: bool = False) -> int:
    """Estimator-path residual coding: updates ctx state arrays in place,
    returns the frac-bit delta (SCALE_BITS fixed point)."""
    h, w = coeff.shape
    c = np.ascontiguousarray(coeff, dtype=np.int32)
    return int(_LIB.vte_est_residual(
        _i32p(c), w, h, 1 if is_luma else 0, 1 if dep_quant else 0,
        1 if sign_hiding else 0,
        _u16p(ctx.state0), _u16p(ctx.state1),
        _u8p(ctx.rate0), _u8p(ctx.rate1)))


_TLS = None


def _tls():
    global _TLS
    if _TLS is None:
        import threading
        _TLS = threading.local()
    if not hasattr(_TLS, "wr_buf"):
        _TLS.wr_buf = np.empty(1 << 16, dtype=np.uint8)
        _TLS.wr_state = np.empty(5, dtype=np.int64)
    return _TLS


def write_residual(coeff: np.ndarray, is_luma: bool, dep_quant: bool,
                   sign_hiding: bool, enc) -> None:
    """Writer-path residual coding on a CabacEncoder: encodes the TU's bins
    through the native arithmetic engine, bit-exact vs the Python path."""
    h, w = coeff.shape
    c = np.ascontiguousarray(coeff, dtype=np.int32)
    tls = _tls()
    st, buf = tls.wr_state, tls.wr_buf
    st[0] = enc.low
    st[1] = enc.range
    st[2] = enc.buffered_byte
    st[3] = enc.num_buffered_bytes
    st[4] = enc.bits_left
    ctx = enc.ctx
    nb = _LIB.vte_write_residual(
        _i32p(c), w, h, 1 if is_luma else 0, 1 if dep_quant else 0,
        1 if sign_hiding else 0,
        _u16p(ctx.state0), _u16p(ctx.state1),
        _u8p(ctx.rate0), _u8p(ctx.rate1),
        st.ctypes.data, _u8p(buf))
    enc.low = int(st[0])
    enc.range = int(st[1])
    enc.buffered_byte = int(st[2])
    enc.num_buffered_bytes = int(st[3])
    enc.bits_left = int(st[4])
    if nb:
        bw = enc.bw
        data = buf[:nb].tobytes()
        if bw.is_byte_aligned():
            bw.append_bytes(data)
        else:
            for b in data:
                bw.write(b, 8)


def tq_trial(resi: np.ndarray, pred: np.ndarray, src: np.ndarray,
             trh: int, trv: int, qp: int, bit_depth: int, is_luma: bool,
             lmbda: float, ctx, cbf_ctx_id=None, sdh: bool = False,
             dq: bool = False):
    """Fused forward-transform + quantization (+SDH) + dequant +
    inverse-transform + reconstruction + SSE, one native call (the
    encoder RD inner loop).  dq=True runs the dependent-quantization
    trellis instead of RDOQ (with the state-machine dequant).
    Returns (coeff|None, rec, dist); coeff is None when the TU quantizes
    to all-zero (rec == clipped pred)."""
    h, w = resi.shape
    r = np.ascontiguousarray(resi, dtype=np.int32)
    p = np.ascontiguousarray(pred, dtype=np.int32)
    s = np.ascontiguousarray(src, dtype=np.int32)
    coeff = np.empty((h, w), dtype=np.int32)
    rec = np.empty((h, w), dtype=np.int32)
    dist = np.zeros(1, dtype=np.int64)
    cbf = _LIB.vte_tq_trial(
        _i32p(r), _i32p(p), _i32p(s), w, h, trh, trv, qp, bit_depth,
        1 if is_luma else 0, float(lmbda),
        -1 if cbf_ctx_id is None else int(cbf_ctx_id), 1 if sdh else 0,
        _u16p(ctx.state0), _u16p(ctx.state1),
        _i32p(coeff), _i32p(rec), dist.ctypes.data, 1 if dq else 0)
    return (coeff if cbf else None), rec, int(dist[0])


def tq_quant(resi: np.ndarray, trh: int, trv: int, qp: int, bit_depth: int,
             is_luma: bool, lmbda: float, ctx, cbf_ctx_id=None,
             sdh: bool = False, dq: bool = False):
    """Fused forward-transform + RDOQ/trellis (+SDH), one native call.
    Returns the quantized levels [h, w] int32, or None when all-zero."""
    h, w = resi.shape
    r = np.ascontiguousarray(resi, dtype=np.int32)
    coeff = np.empty((h, w), dtype=np.int32)
    cbf = _LIB.vte_tq_quant(
        _i32p(r), w, h, trh, trv, qp, bit_depth, 1 if is_luma else 0,
        float(lmbda), -1 if cbf_ctx_id is None else int(cbf_ctx_id),
        1 if sdh else 0, _u16p(ctx.state0), _u16p(ctx.state1), _i32p(coeff),
        1 if dq else 0)
    return coeff if cbf else None


def predict_intra(top: np.ndarray, left: np.ndarray, mode: int, w: int,
                  h: int, bit_depth: int, is_luma: bool, ref_idx: int = 0,
                  cu_dims=None, isp: bool = False, override_pdpc=None
                  ) -> np.ndarray:
    """Native intra prediction (ops/intra.py port) -> [h, w] int32."""
    t = np.ascontiguousarray(top, dtype=np.int32)
    l_ = np.ascontiguousarray(left, dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    cw, ch = cu_dims if cu_dims is not None else (-1, -1)
    _LIB.vte_predict_intra(
        _i32p(t), len(t), _i32p(l_), len(l_), mode, w, h, bit_depth,
        1 if is_luma else 0, ref_idx, cw, ch, 1 if isp else 0,
        -1 if override_pdpc is None else int(bool(override_pdpc)),
        _i32p(out))
    return out


def predict_modes(top: np.ndarray, left: np.ndarray, modes, w: int, h: int,
                  bit_depth: int, is_luma: bool, ref_idx: int = 0,
                  override_pdpc=None) -> np.ndarray:
    """Native batched intra prediction over shared references ->
    [len(modes), h, w] int32 (one crossing for the whole mode list)."""
    t = np.ascontiguousarray(top, dtype=np.int32)
    l_ = np.ascontiguousarray(left, dtype=np.int32)
    m = np.ascontiguousarray(modes, dtype=np.int32)
    out = np.empty((len(m), h, w), dtype=np.int32)
    _LIB.vte_predict_modes(
        _i32p(t), len(t), _i32p(l_), len(l_), _i32p(m), len(m), w, h,
        bit_depth, 1 if is_luma else 0, ref_idx,
        -1 if override_pdpc is None else int(bool(override_pdpc)),
        _i32p(out))
    return out


def satd_modes(src: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """vvenc-convention SATD of src [h, w] vs preds [M, h, w] -> [M]."""
    m, h, w = preds.shape
    s = np.ascontiguousarray(src, dtype=np.int32)
    p = np.ascontiguousarray(preds, dtype=np.int32)
    out = np.empty(m, dtype=np.int64)
    _LIB.vte_satd_modes(s.ctypes.data, p.ctypes.data, m, w, h,
                        out.ctypes.data)
    return out


def presel_satd(top: np.ndarray, left: np.ndarray, src: np.ndarray,
                modes, w: int, h: int, bit_depth: int,
                is_luma: bool = True, ref_idx: int = 0) -> np.ndarray:
    """Fused predict+SATD over shared references -> int64 [len(modes)];
    predictions never cross back into Python."""
    t = np.ascontiguousarray(top, dtype=np.int32)
    l_ = np.ascontiguousarray(left, dtype=np.int32)
    s = np.ascontiguousarray(src, dtype=np.int32)
    m = np.ascontiguousarray(modes, dtype=np.int32)
    out = np.empty(len(m), dtype=np.int64)
    _LIB.vte_presel_satd(t.ctypes.data, len(t), l_.ctypes.data,
                         len(l_), s.ctypes.data, m.ctypes.data, len(m),
                         w, h, bit_depth, 1 if is_luma else 0, ref_idx,
                         out.ctypes.data)
    return out


def build_refs(rec: np.ndarray, x: int, y: int, w: int, h: int,
               coded_mask: np.ndarray, unit: int, bit_depth: int,
               ref_idx: int = 0, pred_sizes=None):
    """Reference-sample builder (coded-mask path) -> (top, left)."""
    ph, pw = rec.shape
    cuh, cuw = coded_mask.shape
    psz, phs = pred_sizes if pred_sizes is not None else (-1, -1)
    eff_ps = (psz if psz > 0 else 2 * w) + ref_idx
    eff_hs = (phs if phs > 0 else 2 * h) + ref_idx
    top = np.empty(eff_ps + 3, dtype=np.int32)
    left = np.empty(eff_hs + 3, dtype=np.int32)
    r = np.ascontiguousarray(rec, dtype=np.int32)
    c = coded_mask.view(np.uint8) if coded_mask.dtype == np.bool_ \
        and coded_mask.flags.c_contiguous \
        else np.ascontiguousarray(coded_mask, dtype=np.uint8)
    _LIB.vte_build_refs(r.ctypes.data, ph, pw, x, y, w, h,
                        c.ctypes.data, cuh, cuw, unit, bit_depth, ref_idx,
                        psz, phs, top.ctypes.data, left.ctypes.data)
    return top, left


def cclm_predict_many(ps, cu, bit_depth: int, ctu_size: int, modes,
                      comps=(1, 2)) -> dict:
    """Native CCLM predictions for modes x components -> {(mode, comp):
    pred [ch, cw] int32}; shared availability/downsample work in C++."""
    luma = ps.rec[0]
    cb, cr = ps.rec[1], ps.rec[2]
    coded = ps.avail_chroma()
    c = coded.view(np.uint8) if coded.dtype == np.bool_ \
        and coded.flags.c_contiguous \
        else np.ascontiguousarray(coded, dtype=np.uint8)
    uh, uw = coded.shape
    ph, pw = luma.shape
    cph, cpw = cb.shape
    cw, ch = cu.w >> 1, cu.h >> 1
    m = np.ascontiguousarray(list(modes), dtype=np.int32)
    preds = np.empty((len(m), 2, ch, cw), dtype=np.int32)
    _LIB.vte_cclm_predict(
        luma.ctypes.data, cb.ctypes.data, cr.ctypes.data, ph, pw, cph,
        cpw, c.ctypes.data, uh, uw, cu.x, cu.y, cu.w, cu.h, ctu_size,
        bit_depth, m.ctypes.data, len(m), preds.ctypes.data)
    out = {}
    for i, mode in enumerate(m.tolist()):
        for ci, comp in enumerate((1, 2)):
            if comp in comps:
                out[(mode, comp)] = preds[i, ci]
    return out


def fwd_transform(resi: np.ndarray, bit_depth: int, trh: int, trv: int
                  ) -> np.ndarray:
    h, w = resi.shape
    r = np.ascontiguousarray(resi, dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    _LIB.vte_fwd_transform(r.ctypes.data, w, h, trh, trv, bit_depth,
                           out.ctypes.data)
    return out


def inv_transform(d: np.ndarray, bit_depth: int, trh: int, trv: int
                  ) -> np.ndarray:
    h, w = d.shape
    c = np.ascontiguousarray(d, dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    _LIB.vte_inv_transform(c.ctypes.data, w, h, trh, trv, bit_depth,
                           out.ctypes.data)
    return out


def dequant(qc: np.ndarray, qp: int, bit_depth: int) -> np.ndarray:
    h, w = qc.shape
    c = np.ascontiguousarray(qc, dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    _LIB.vte_dequant(c.ctypes.data, w, h, qp, bit_depth, out.ctypes.data)
    return out


def rdoq(coeff: np.ndarray, qp: int, bit_depth: int, is_luma: bool,
         lmbda: float, ctx, cbf_ctx_id=None) -> np.ndarray:
    h, w = coeff.shape
    c = np.ascontiguousarray(coeff, dtype=np.int32)
    out = np.zeros((h, w), dtype=np.int32)
    _LIB.vte_rdoq(_i32p(c), w, h, qp, bit_depth, 1 if is_luma else 0,
                  float(lmbda), -1 if cbf_ctx_id is None else int(cbf_ctx_id),
                  _u16p(ctx.state0), _u16p(ctx.state1), _i32p(out))
    return out


# ---------------------------------------------------------------------------
# native CTU search driver (EncCu::xCompressCtu analog): the full
# intra-slice RD search of one CTU in one C++ call (entropy.cpp
# vte_search_ctu) — bit-exact vs the Python _CtuSearcher
# ---------------------------------------------------------------------------

_SEARCH_READY = False


def _search_setup():
    """Declare + initialize the search entry points (lazy, once)."""
    global _SEARCH_READY
    if _SEARCH_READY or _LIB is None:
        return _LIB is not None
    from ..bitstream import ctx_tables as ct
    _LIB.vte_search_init.argtypes = [_PI32]
    _LIB.vte_search_init.restype = None
    _LIB.vte_search_ctu.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_double] * 2 + [ctypes.c_int] * 7
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_double,
           ctypes.c_double]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_int] * 3)
    _LIB.vte_search_ctu.restype = ctypes.c_int
    _LIB.vte_search_init_inter.argtypes = [_PI32]
    _LIB.vte_search_init_inter.restype = None
    _LIB.vte_inter_new.argtypes = (
        [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2)
    _LIB.vte_inter_new.restype = ctypes.c_void_p
    _LIB.vte_inter_free.argtypes = [ctypes.c_void_p]
    _LIB.vte_inter_free.restype = None
    _LIB.vte_inter_set_me.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _LIB.vte_inter_set_me.restype = None
    _LIB.vte_inter_set_tools.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 17 + [ctypes.c_void_p] * 2)
    _LIB.vte_inter_set_tools.restype = None
    offs_i = np.asarray([
        ct.CTX_SETS["SkipFlag"](0), ct.CTX_SETS["PredMode"](0),
        ct.CTX_SETS["MergeFlag"](0), ct.CTX_SETS["MergeIdx"](0),
        ct.CTX_SETS["InterDir"](0), ct.CTX_SETS["RefPic"](0),
        ct.CTX_SETS["Mvd"](0), ct.CTX_SETS["MVPIdx"](0),
        ct.CTX_SETS["QtRootCbf"](0), ct.CTX_SETS["SubblockMergeFlag"](0),
        ct.CTX_SETS["RegularMergeFlag"](0), ct.CTX_SETS["MmvdFlag"](0),
        ct.CTX_SETS["MmvdMergeIdx"](0), ct.CTX_SETS["MmvdStepMvpIdx"](0),
        ct.CTX_SETS["CiipFlag"](0), ct.CTX_SETS["SmvdFlag"](0),
        ct.CTX_SETS["AffineFlag"](0), ct.CTX_SETS["AffineType"](0),
        ct.CTX_SETS["ImvFlag"](0), ct.CTX_SETS["BcwIdx"](0),
        ct.CTX_SETS["DeltaQP"](0), ct.CTX_SETS["AffMergeIdx"](0)],
        dtype=np.int32)
    _LIB.vte_search_init_inter(offs_i.ctypes.data)
    offs = np.asarray([
        ct.CTX_SETS["SplitFlag"](0), ct.CTX_SETS["SplitQtFlag"](0),
        ct.CTX_SETS["SplitHvFlag"](0), ct.CTX_SETS["Split12Flag"](0),
        ct.CTX_SETS["IntraLumaMpmFlag"](0),
        ct.CTX_SETS["IntraLumaPlanarFlag"](0),
        ct.CTX_SETS["IntraChromaPredMode"](0),
        ct.CTX_SETS["CclmModeFlag"](0), ct.CTX_SETS["CclmModeIdx"](0),
        ct.CTX_SETS["QtCbfLuma"](0), ct.CTX_SETS["QtCbfCb"](0),
        ct.CTX_SETS["QtCbfCr"](0), ct.CTX_SETS["MipFlag"](0),
        ct.CTX_SETS["MultiRefLineIdx"](0), ct.CTX_SETS["LFNSTIdx"](0),
        ct.CTX_SETS["JointCbCrFlag"](0), ct.CTX_SETS["ISPMode"](0),
        ct.NUM_CTX], dtype=np.int32)
    _LIB.vte_search_init(offs.ctypes.data)
    _SEARCH_READY = True
    return True


def search_eligible(searcher) -> bool:
    """True when the native driver covers this picture's tool set.

    Intra slices: RDOQ or the dependent-quantization trellis, QT+BT+TT
    partitioning to any MTT depth and CTU size, MIP, MRL, ISP, LFNST,
    JCCR, implicit MTS, CCLM, and per-CTU QP (QPA/BIM DQP) — the full
    medium-preset intra tool stack.

    Inter (P/B) slices: the faster-preset toolset — merge/skip + AMVP
    uni/bi + DMVR + TMVP + the gated intra fallback (EncCu.cpp:717 mode
    loop scope at preset faster).  Tools that still fall back to the
    Python searcher: affine/SbTMVP, MMVD, GEO, CIIP, SMVD, AMVR, BCW,
    BDOF, SBT, per-CTU QP (QPA), CTU 128 (>maxTB tiling).

    Always excluded (Python searcher handles them): explicit MTS,
    transform-skip/BDPCM/IBC (SCC), LMCS, tiles, IFP rows."""
    if _LIB is None or not _search_setup():
        return False
    coder, cfg, sps = searcher.coder, searcher.cfg, searcher.enc.sps
    ps = searcher.ps
    common = (not getattr(searcher.enc, "trial_filter", None)
              and bool(cfg.rdoq or cfg.dep_quant)
              and not sps.mts_intra
              and not sps.transform_skip and not getattr(sps, "bdpcm", 0)
              and not coder.ibc_en and not coder.bdpcm_en
              and coder.reshape is None
              and ps.tile_map is None)
    if not common:
        return False
    if coder.is_intra_slice:
        return True
    return (not coder.ciip_en and not coder.bcw_en
            and not getattr(sps, "sbt", 0)
            and coder.num_refs[0] <= 8 and coder.num_refs[1] <= 8
            and not getattr(coder.sh.ph, "partition_override", None))


def _mi_rows(lut):
    """MotionInfo list -> int32 [n, 12] rows for the native HMVP."""
    rows = np.zeros((len(lut), 12), np.int32)
    for i, mi in enumerate(lut):
        rows[i, 0:2] = mi.mv[0]
        rows[i, 2:4] = mi.mv[1]
        rows[i, 4:6] = mi.ref_idx
        rows[i, 6] = mi.bcw
        rows[i, 7] = 1 if mi.alt_hpel else 0
    return rows


def inter_setup(searcher):
    """Build (once per picture) the native inter context handle: reference
    planes, POCs, TMVP collocated motion, the live motion-field arrays and
    the device pre-ME tables.  Returns the ctypes handle (int)."""
    prep = getattr(searcher, "_ninter_prep", None)
    if prep is not None:
        return prep[0]
    import weakref
    _mc_setup()   # chroma MC taps ROM (the native search MCs internally)
    coder = searcher.coder
    cfg = searcher.cfg
    sps = searcher.enc.sps
    keep = []
    plane_ptrs = np.zeros(2 * 8 * 3, np.int64)
    ref_pocs = np.zeros(2 * 8, np.int32)
    for li in range(2):
        for ri in range(len(coder.ref_pics[li])):
            for comp in range(3):
                pl = np.ascontiguousarray(coder.ref_pics[li][ri][comp],
                                          dtype=np.int32)
                keep.append(pl)
                plane_ptrs[(li * 8 + ri) * 3 + comp] = pl.ctypes.data
            ref_pocs[li * 8 + ri] = coder.ref_pocs[li][ri]
    tmvp = coder.tmvp
    col_ref_pocs = np.zeros(2 * 8, np.int32)
    if tmvp is not None:
        col_mf = tmvp.col_mf
        col_valid = col_mf.valid
        col_mv = col_mf.mv
        col_ref = col_mf.ref
        keep += [col_valid, col_mv, col_ref]
        for li in range(2):
            for ri, p in enumerate(tmvp.col_ref_pocs[li][:8]):
                col_ref_pocs[li * 8 + ri] = p
        cvp, cmp_, crp = (col_valid.ctypes.data, col_mv.ctypes.data,
                          col_ref.ctypes.data)
        col_poc, col_l0 = tmvp.col_poc, tmvp.col_from_l0
        check_ldc = tmvp.check_ldc
    else:
        cvp = cmp_ = crp = 0
        col_poc = col_l0 = 0
        check_ldc = all(p <= coder.cur_poc for li in range(2)
                        for p in coder.ref_pocs[li])
    mf = coder.mf
    handle = _LIB.vte_inter_new(
        searcher.ps.w, searcher.ps.h, cfg.ctu_size, cfg.bit_depth,
        coder.cur_poc, 1 if coder.is_b else 0, sps.max_num_merge_cand,
        coder.num_refs[0], coder.num_refs[1],
        plane_ptrs.ctypes.data, ref_pocs.ctypes.data,
        1 if tmvp is not None else 0, cvp, cmp_, crp,
        col_poc, col_l0, col_ref_pocs.ctypes.data, 0, 0,
        1 if check_ldc else 0,
        1 if getattr(coder.sh.ph, "mvd_l1_zero", 0) else 0,
        1 if coder.dmvr_on and not getattr(coder.sh.ph, "dis_dmvr", 0)
        else 0,
        1 if coder.bdof_on and not getattr(coder.sh.ph, "dis_bdof", 0)
        else 0,
        cfg.search_range,
        mf.valid.ctypes.data, mf.mv.ctypes.data, mf.ref.ctypes.data,
        mf.bcw.ctypes.data, mf.alt.ctypes.data, mf.skipf.ctypes.data,
        mf.isaff.ctypes.data, mf.uw, mf.uh)
    keep += [plane_ptrs, ref_pocs, col_ref_pocs, mf]
    _LIB.vte_inter_set_tools(
        handle, 1 if coder.mmvd else 0,
        1 if getattr(coder.sh.ph, "fpel_mmvd", 0) else 0,
        1 if coder.geo_en else 0, coder.max_geo_cand,
        1 if coder.smvd_en else 0, 1 if coder.bi_dir_pred else 0,
        coder.sym_ref[0], coder.sym_ref[1],
        1 if coder.amvr else 0, 1 if coder.affine_en else 0,
        1 if coder.affine_type_en else 0,
        1 if coder.affine_amvr_en else 0,
        1 if coder.prof_en else 0, 1 if coder.sbtmvp_active else 0,
        coder.max_aff_merge, 1 if coder.ciip_en else 0,
        1 if coder.bcw_en else 0,
        mf.aff_valid.ctypes.data, mf.aff_data.ctypes.data)
    if not searcher._use_device_me():
        # the native search's coarse stage runs on the host: one count a
        # reference picture, as _device_me counts K5's tables
        from ..utils.profiler import PROF
        PROF.count("inter.me_centers", "host", len(
            {id(p[0]) for li in range(2) for p in coder.ref_pics[li]}))
    else:
        # device pre-ME tables (shared with the Python searcher's cache
        # so check mode sees identical coarse stages)
        for li in range(2):
            for ri in range(len(coder.ref_pics[li])):
                ref_y = coder.ref_pics[li][ri][0]
                tab = searcher._device_me(ref_y)
                # _device_me raises rather than handing back no table
                assert tab is not None, "device ME table missing"
                t = np.ascontiguousarray(tab.mv, dtype=np.int32)
                keep.append(t)
                _LIB.vte_inter_set_me(
                    handle, li, ri, t.ctypes.data, t.shape[1],
                    t.shape[0], tab.bs, 1)
    searcher._ninter_prep = (handle, keep)
    weakref.finalize(searcher, _LIB.vte_inter_free, handle)
    return handle


def search_ctu(searcher, ctu_x: int, ctu_y: int, live_ctx, commit=True,
               wavefront=None):
    """Run the native CTU search; returns the TreeNode (same tree the
    Python searcher produces) or None on native-side failure.

    commit=True leaves the chosen tree's reconstruction + attribute
    marks in the picture state and flags the CUs recon_done so the
    writer replay skips finish_cu's re-reconstruction.  Pass False when
    a Python search will run on the same state afterwards (check
    mode).

    wavefront: phase-1 WPP mode (commit==2 in C++) — a dict carrying the
    CTU's row-chained state instead of the live coder state:
      ctx: object with state0/state1/rate0/rate1 arrays (written back)
      hmvp: int32 [N,12] row buffer, hmvp_n: live rows (returned count)
      dqp_coded: bool (returned), lmbda/lmbda_sad: per-CTU lambda
      qp: (luma, cb, cr, qp_y, joint) per-CTU QPs
      bufs: (out_tree, out_coeff, out_n) per-thread buffers
    The searcher keeps its committed maps/motion (no restore); the
    caller resets the picture arrays before the serial replay.  Returns
    (tree, hmvp_n, dqp_coded)."""
    from ..codec.ctu_syntax import (CHROMA_TREE, MODE_INTRA, NO_SPLIT,
                                    TREE_L, CuData, PartInfo, TreeNode,
                                    implicit_split, split_geometry)
    ps = searcher.ps
    cfg = searcher.cfg
    sps = searcher.enc.sps
    coder = searcher.coder
    qp = searcher.qp

    # per-picture prepared state (cached on the searcher)
    prep = getattr(searcher, "_nsearch_prep", None)
    if prep is None:
        src = [np.ascontiguousarray(p, dtype=np.int32)
               for p in (searcher.src[0], searcher.src[1], searcher.src[2])]
        presel_meta = np.zeros((0, 6), np.int32)
        presel_ptrs = np.zeros(0, np.int64)
        presel_keep = []
        plan_meta = np.zeros((0, 6), np.int32)
        plan_ptrs = np.zeros(0, np.int64)
        plan = searcher._get_plan() \
            if coder.is_intra_slice and searcher._use_plan() else None
        if plan is not None:
            metas, ptrs = [], []
            for (w, h), (xs, ys, ax, ay, nx, rows) in plan.tables.items():
                r = np.ascontiguousarray(rows, dtype=np.int32)
                presel_keep.append(r)
                metas.append((w, h, ax, ay, nx, len(ys)))
                ptrs.append(r.ctypes.data)
            if metas:
                plan_meta = np.asarray(metas, dtype=np.int32)
                plan_ptrs = np.asarray(ptrs, dtype=np.int64)
        elif coder.is_intra_slice and searcher._use_presel():
            tab = searcher._get_presel()
            metas, ptrs = [], []
            for (w, h), (xs, ys, ax, ay, nx, costs) in tab.tables.items():
                c = np.ascontiguousarray(costs, dtype=np.int32)
                presel_keep.append(c)
                metas.append((w, h, ax, ay, nx, len(ys)))
                ptrs.append(c.ctypes.data)
            if metas:
                presel_meta = np.asarray(metas, dtype=np.int32)
                presel_ptrs = np.asarray(ptrs, dtype=np.int64)
        sps_arr = {
            "min_qt": np.asarray(sps.min_qt_size, np.int32),
            "max_mtt": np.asarray(sps.max_mtt_depth, np.int32),
            "max_bt": np.asarray(sps.max_bt_size, np.int32),
            "max_tt": np.asarray(sps.max_tt_size, np.int32),
        }
        out_tree = np.empty(1 << 16, np.int32)
        out_coeff = np.empty(1 << 16, np.int32)
        out_n = np.empty(4, np.int32)
        prep = (src, presel_meta, presel_ptrs, presel_keep, sps_arr,
                out_tree, out_coeff, out_n, plan_meta, plan_ptrs)
        searcher._nsearch_prep = prep
    (src, presel_meta, presel_ptrs, _keep, sps_arr, out_tree, out_coeff,
     out_n, plan_meta, plan_ptrs) = prep

    def b8(a):
        return a.view(np.uint8) if a.dtype == np.bool_ else a

    if coder.is_intra_slice:
        ih, hm_ptr, hm_n = 0, 0, 0
        _hm_keep = None
    else:
        ih = inter_setup(searcher)
        if wavefront is not None:
            _hm_keep = wavefront["hmvp"]
            hm_ptr = _hm_keep.ctypes.data
            hm_n = int(wavefront["hmvp_n"])
        else:
            _hm_keep = _mi_rows(coder.hmvp.lut)
            hm_ptr = _hm_keep.ctypes.data
            hm_n = len(_hm_keep)

    if wavefront is not None:
        wctx = wavefront["ctx"]
        st0, st1 = wctx.state0, wctx.state1
        rt0, rt1 = wctx.rate0, wctx.rate1
        qp_l, qp_cb, qp_cr, qp_yv, qp_jc = wavefront["qp"]
        lmb = float(wavefront["lmbda"])
        lmb_sad = float(wavefront["lmbda_sad"])
        dqpc = 1 if wavefront["dqp_coded"] else 0
        commit_flag = 2
        out_tree, out_coeff, out_n = wavefront["bufs"]
    else:
        st0, st1 = live_ctx.state0, live_ctx.state1
        rt0, rt1 = live_ctx.rate0, live_ctx.rate1
        qp_l, qp_cb, qp_cr = qp.luma_qp(), qp.chroma_qp(1), qp.chroma_qp(2)
        qp_yv, qp_jc = qp.qp_y, qp.joint_qp()
        lmb = float(searcher.lmbda)
        lmb_sad = float(searcher.lmbda_sad)
        dqpc = 1 if coder.dqp_coded else 0
        commit_flag = 1 if commit else 0

    args = (
        ps.w, ps.h, cfg.bit_depth, ctu_x, ctu_y, cfg.ctu_size,
        _i32p(ps.rec[0]), _i32p(ps.rec[1]), _i32p(ps.rec[2]),
        _i32p(src[0]), _i32p(src[1]), _i32p(src[2]),
        _u8p(b8(ps.coded_luma)), _i32p(ps.intra_mode),
        _u8p(b8(ps.is_intra)), _u8p(b8(ps.is_mip)), _i32p(ps.cu_w),
        _i32p(ps.cu_h), _i32p(ps.qt_depth), _i32p(ps.qp_map),
        ps.coded_luma.shape[0], ps.coded_luma.shape[1],
        _u8p(b8(ps.coded_chroma)), _i32p(ps.ccu_w), _i32p(ps.ccu_h),
        _i32p(ps.cqt_depth),
        ps.coded_chroma.shape[0], ps.coded_chroma.shape[1],
        _u16p(st0), _u16p(st1),
        _u8p(rt0), _u8p(rt1),
        _i32p(sps_arr["min_qt"]), _i32p(sps_arr["max_mtt"]),
        _i32p(sps_arr["max_bt"]), _i32p(sps_arr["max_tt"]),
        sps.log2_min_cb_size, qp_l, qp_cb,
        qp_cr, qp_yv, lmb,
        lmb_sad, cfg.num_full_rd_modes,
        cfg.num_chroma_rd_modes, 1 if cfg.sign_data_hiding else 0,
        1 if coder.dual_tree_intra else 0, 1 if sps.cclm else 0,
        1 if coder.implicit_mts else 0, coder.tree_idx,
        len(presel_meta), _i32p(presel_meta), presel_ptrs.ctypes.data,
        len(plan_meta), _i32p(plan_meta), plan_ptrs.ctypes.data,
        _i32p(out_tree), len(out_tree), _i32p(out_coeff), len(out_coeff),
        out_n.ctypes.data, commit_flag,
        1 if cfg.dep_quant else 0, 1 if sps.mip else 0,
        1 if sps.mrl else 0, 1 if sps.lfnst else 0,
        1 if coder.jccr else 0, 1 if coder.jccr_sign else 0,
        qp_jc, 1 if sps.isp else 0,
        float(searcher.cw[1]), float(searcher.cw[2]),
        ih, hm_ptr, hm_n,
        1 if coder.use_dqp else 0, dqpc,
        -1 if searcher.ifp_bottom is None else int(searcher.ifp_bottom))
    try:
        rc = _LIB.vte_search_ctu(*args)
    except ctypes.ArgumentError:
        for _i, _a in enumerate(args):
            print('arg', _i + 1, type(_a), repr(_a)[:60])
        raise

    if rc != 0:
        return None

    # deserialize into the TreeNode structure the Python searcher builds
    state = {"ti": 0, "ci": 0}
    tree, coeff = out_tree, out_coeff

    def tok():
        v = int(tree[state["ti"]])
        state["ti"] += 1
        return v

    def block(h, w):
        n = h * w
        a = coeff[state["ci"]:state["ci"] + n].reshape(h, w).copy()
        state["ci"] += n
        return a

    def read_node(x, y, w, h, part):
        split = tok()
        node = TreeNode(x, y, max(w, h), part.qt_depth, w=w, h=h, part=part,
                        split_mode=split, split=split != NO_SPLIT)
        tidx = 2 if part.tree_type == CHROMA_TREE else coder.tree_idx
        if split != NO_SPLIT:
            impl = implicit_split(ps, x, y, w, h, part, sps, tidx)
            is_impl = split == impl
            for idx, (cx, cy, cw, chh) in enumerate(
                    split_geometry(split, x, y, w, h)):
                if cx >= ps.w or cy >= ps.h:
                    continue
                node.children.append(
                    read_node(cx, cy, cw, chh,
                              part.child(split, idx, is_impl)))
            return node
        if part.tree_type == CHROMA_TREE:
            cu = CuData(x, y, w, h)
            cu.recon_done = commit
            cu.chroma_only = True
            cu.luma_mode = tok()
            cu.chroma_dir = tok()
            cu.cclm_allowed = bool(tok())
            cu.lfnst_idx = tok()
            cu.joint_cbcr = tok()
            cbf_cb, cbf_cr = tok(), tok()
            if cbf_cb:
                cu.coeff_cb = block(h >> 1, w >> 1)
            if cbf_cr:
                cu.coeff_cr = block(h >> 1, w >> 1)
            node.cu = cu
            return node
        if not coder.is_intra_slice:
            # inter-slice CU layout (serialize() inter_slice branch)
            is_inter = bool(tok())
            cu = CuData(x, y, w, h, is_inter=is_inter)
            cu.recon_done = commit
            if is_inter:
                cu.skip = bool(tok())
                cu.merge = bool(tok())
                cu.merge_idx = tok()
                cu.mmvd_flag = bool(tok())
                cu.mmvd_base = tok()
                cu.mmvd_step = tok()
                cu.mmvd_pos = tok()
                cu.geo = bool(tok())
                cu.geo_split_dir = tok()
                cu.geo_idx0 = tok()
                cu.geo_idx1 = tok()
                cu.affine = bool(tok())
                cu.affine_type = tok()
                cu.sbtmvp = bool(tok())
                if cu.affine and not cu.merge:
                    cu.aff_mvds = (
                        [(tok(), tok()) for _ in range(3)],
                        [(tok(), tok()) for _ in range(3)])
                cu.mv = ((tok(), tok()), (tok(), tok()))
                cu.ref_idx = (tok(), tok())
                cu.mvd = (tok(), tok())
                cu.mvp_idx = tok()
                cu.mvd_l1 = (tok(), tok())
                cu.mvp_idx_l1 = tok()
                cu.bcw_idx = tok()
                cu.alt_hpel = bool(tok())
                cu.imv = tok()
                cu.smvd = bool(tok())
                cu.root_cbf = bool(tok())
                nd = tok()
                if nd:
                    cu.dmvr_deltas = {}
                    cu.dmvr_bdof = {}
                    for _ in range(nd):
                        sy_, sx_ = tok(), tok()
                        dx_, dy_ = tok(), tok()
                        bd_ = tok()
                        cu.dmvr_deltas[(sy_, sx_)] = (dx_, dy_)
                        cu.dmvr_bdof[(sy_, sx_)] = bool(bd_)
                if tok():
                    # implicit max-TB TU tiling (>64 inter CU)
                    cu.mtb_tus = []
                    for _ in range(tok()):
                        tx_, ty_, tw_, th_ = tok(), tok(), tok(), tok()
                        cy_ = block(th_, tw_) if tok() else None
                        cbf_cb2, cbf_cr2 = tok(), tok()
                        ccb = block(th_ >> 1, tw_ >> 1) if cbf_cb2 else None
                        ccr = block(th_ >> 1, tw_ >> 1) if cbf_cr2 else None
                        cu.mtb_tus.append((tx_, ty_, tw_, th_, cy_, ccb,
                                           ccr, 0, False, False))
                    node.cu = cu
                    return node
            else:
                cu.luma_mode = tok()
                cu.chroma_dir = tok()
                cu.lfnst_idx = tok()
                cu.joint_cbcr = tok()
            if tok():
                cu.coeff_y = block(h, w)
            cbf_cb, cbf_cr = tok(), tok()
            if cbf_cb:
                cu.coeff_cb = block(h >> 1, w >> 1)
            if cbf_cr:
                cu.coeff_cr = block(h >> 1, w >> 1)
            node.cu = cu
            return node
        lo = part.tree_type == TREE_L
        cu = CuData(x, y, w, h, luma_only=lo)
        cu.recon_done = commit
        cu.luma_mode = tok()
        cu.mip_flag = bool(tok())
        cu.mip_transposed = bool(tok())
        cu.ref_line = tok()
        cu.lfnst_idx = tok()
        cu.joint_cbcr = tok()
        cu.isp_mode = tok()
        if cu.isp_mode:
            from ..codec.ctu_syntax import isp_partitions
            cu.isp_coeffs = []
            for (_px, _py, pw_, ph_) in isp_partitions(w, h, cu.isp_mode):
                cu.isp_coeffs.append(block(ph_, pw_) if tok() else None)
        elif tok():
            cu.coeff_y = block(h, w)
        if not lo:
            cu.chroma_dir = tok()
            cbf_cb, cbf_cr = tok(), tok()
            if cbf_cb:
                cu.coeff_cb = block(h >> 1, w >> 1)
            if cbf_cr:
                cu.coeff_cr = block(h >> 1, w >> 1)
        node.cu = cu
        return node

    ctu = cfg.ctu_size
    if coder.dual_tree_intra:
        node = TreeNode(ctu_x, ctu_y, ctu, 0, w=ctu, h=ctu, part=PartInfo())
        unit = min(64, ctu)
        qtd = 1 if ctu > 64 else 0
        for uy in range(ctu_y, ctu_y + ctu, unit):
            for ux in range(ctu_x, ctu_x + ctu, unit):
                if ux >= ps.w or uy >= ps.h:
                    continue
                pl = PartInfo(qt_depth=qtd, subdiv=2 * qtd,
                              mode_type=MODE_INTRA, tree_type=TREE_L)
                lnode = read_node(ux, uy, unit, unit, pl)
                # luma64 record for the replay's CCLM gate
                coder.luma64[(ux, uy)] = [
                    lnode.split_mode,
                    bool(lnode.cu.isp_mode) if lnode.cu is not None
                    else False]
                node.children.append(lnode)
                pc = PartInfo(qt_depth=qtd, subdiv=2 * qtd,
                              mode_type=MODE_INTRA, tree_type=CHROMA_TREE)
                node.children.append(read_node(ux, uy, unit, unit, pc))
    else:
        node = read_node(ctu_x, ctu_y, ctu, ctu, PartInfo())
    assert state["ti"] == int(out_n[0]) and state["ci"] == int(out_n[1]), \
        "native search serialization mismatch"
    if commit_flag and coder.is_intra_slice:
        # the decision as serialized, for the native CTU writer (which
        # codes CUs whose reconstruction the search staged)
        from .ctu_writer import Record
        node.native_rec = Record(out_tree[:state["ti"]].copy(),
                                 out_coeff[:state["ci"]].copy())
    if wavefront is not None:
        return node, int(out_n[2]), bool(out_n[3])
    return node


# ---------------------------------------------------------------------------
# ALF kernels (codec/alf.py hot loops as C++: classification + 7x7/5x5
# clipped diamond filters + CC-ALF — the AdaptiveLoopFilterX86.h analog)
# ---------------------------------------------------------------------------

_ALF_READY = False


def _alf_setup():
    global _ALF_READY
    if _ALF_READY or _LIB is None:
        return _LIB is not None
    _LIB.vte_alf_luma.argtypes = [
        _PI32, _PI32] + [ctypes.c_int] * 6 + [_PI32, _PI32, ctypes.c_int,
                                              _PI32, _PI32] + \
        [ctypes.c_int] * 2
    _LIB.vte_alf_luma.restype = None
    _LIB.vte_alf_chroma.argtypes = [
        _PI32, _PI32] + [ctypes.c_int] * 6 + [_PI32, _PI32] + \
        [ctypes.c_int] * 2
    _LIB.vte_alf_chroma.restype = None
    _LIB.vte_alf_ccalf.argtypes = [
        _PI32, _PI32] + [ctypes.c_int] * 8 + [_PI32] + [ctypes.c_int] * 2
    _LIB.vte_alf_ccalf.restype = None
    _LIB.vte_alf_classify.argtypes = [
        _PI32] + [ctypes.c_int] * 4 + [_PI32, _PI32]
    _LIB.vte_alf_classify.restype = None
    _LIB.vte_alf_stats.argtypes = [
        _PI32, _PI32] + [ctypes.c_int] * 5 + [_PI32, _PI32,
                                              ctypes.c_int, ctypes.c_int,
                                              _PI32, _PI32]
    _LIB.vte_alf_stats.restype = None
    _LIB.vte_sao_stats.argtypes = [
        _PI32, _PI32] + [ctypes.c_int] * 5 + [_PI64] * 4
    _LIB.vte_sao_stats.restype = None
    _LIB.vte_mctf_interp.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int, _PI32, _PI32] +         [ctypes.c_int] * 4 + [_PI32]
    _LIB.vte_mctf_interp.restype = None
    _LIB.vte_mctf_block_me.argtypes = [
        _PI32, _PI32] + [ctypes.c_int] * 4 + [_PI32, _PI32, _PI64]
    _LIB.vte_mctf_block_me.restype = None
    _LIB.vte_mctf_block_ssd.argtypes = [
        _PI32] + [ctypes.c_int] * 3 + [_PI32, _PI32, ctypes.c_int,
                                       _PI32, ctypes.c_int, _PI64]
    _LIB.vte_mctf_block_ssd.restype = None
    _LIB.vte_mctf_mc_plane.argtypes = [
        _PI32] + [ctypes.c_int] * 2 + [_PI32] + [ctypes.c_int] * 6 + \
        [_PI32]
    _LIB.vte_mctf_mc_plane.restype = None
    _ALF_READY = True
    return True


def alf_classify(rec, bit_depth, ctu_size):
    _alf_setup()
    h, w = rec.shape
    r = np.ascontiguousarray(rec, dtype=np.int32)
    cls = np.empty((h // 4, w // 4), np.int32)
    trn = np.empty((h // 4, w // 4), np.int32)
    _LIB.vte_alf_classify(_i32p(r), h, w, bit_depth, ctu_size,
                          _i32p(cls), _i32p(trn))
    return cls, trn


def alf_luma(src, dst, x0, y0, w0, h0, cls, trn, coeff, clipv, bit_depth,
             ctu_size):
    _alf_setup()
    h, w = src.shape
    s = np.ascontiguousarray(src, dtype=np.int32)
    assert dst.dtype == np.int32 and dst.flags.c_contiguous
    c = np.ascontiguousarray(cls, dtype=np.int32)
    t = np.ascontiguousarray(trn, dtype=np.int32)
    co = np.ascontiguousarray(coeff, dtype=np.int32)
    cl = np.ascontiguousarray(clipv, dtype=np.int32)
    _LIB.vte_alf_luma(_i32p(s), _i32p(dst), h, w, x0, y0, w0, h0,
                      _i32p(c), _i32p(t), c.shape[1], _i32p(co), _i32p(cl),
                      bit_depth, ctu_size)


def alf_chroma(src, dst, x0, y0, w0, h0, coeff, clipv, bit_depth,
               ctu_size_c):
    _alf_setup()
    h, w = src.shape
    s = np.ascontiguousarray(src, dtype=np.int32)
    assert dst.dtype == np.int32 and dst.flags.c_contiguous
    co = np.ascontiguousarray(coeff, dtype=np.int32)
    cl = np.ascontiguousarray(clipv, dtype=np.int32)
    _LIB.vte_alf_chroma(_i32p(s), _i32p(dst), h, w, x0, y0, w0, h0,
                        _i32p(co), _i32p(cl), bit_depth, ctu_size_c)


def alf_ccalf(luma, chroma_dst, x0c, y0c, w0c, h0c, coeff, bit_depth,
              ctu_size):
    _alf_setup()
    hc, wc = chroma_dst.shape
    h, w = luma.shape
    lm = np.ascontiguousarray(luma, dtype=np.int32)
    assert chroma_dst.dtype == np.int32 and chroma_dst.flags.c_contiguous
    co = np.ascontiguousarray(coeff, dtype=np.int32)
    _LIB.vte_alf_ccalf(_i32p(lm), _i32p(chroma_dst), hc, wc, h, w,
                       x0c, y0c, w0c, h0c, _i32p(co), bit_depth, ctu_size)


def dmvr_bi_subpu(ref0, ref1, bx, by, bw, bh, mv0, mv1, delta,
                  comp_scale, bit_depth, pic_w, pic_h, ctu_size,
                  alt_hpel=False):
    """DMVR sub-PU final bi-prediction (padded/plain MC both lists +
    14-bit bi average) in one C++ call."""
    _mc_setup()
    ph, pw = ref0.shape
    r0 = np.ascontiguousarray(ref0, dtype=np.int32)
    r1 = np.ascontiguousarray(ref1, dtype=np.int32)
    out = np.empty((bh, bw), np.int32)
    _LIB.vte_dmvr_bi_subpu(
        _i32p(r0), _i32p(r1), ph, pw, bx, by, bw, bh,
        int(mv0[0]), int(mv0[1]), int(mv1[0]), int(mv1[1]),
        int(delta[0]), int(delta[1]), comp_scale, bit_depth, pic_w,
        pic_h, ctu_size, 1 if alt_hpel else 0, _i32p(out))
    return out


def dmvr_padded_mc(ref, x, y, w, h, merge_mv, refined_mv, comp_scale,
                   bit_depth, pic_w, pic_h, ctu_size, intermediate=True,
                   alt_hpel=False):
    """DMVR final MC on the replicate-padded prefetch window
    (ops/dmvr.py padded_window_mc as one C++ call)."""
    _mc_setup()
    ph, pw = ref.shape
    r = np.ascontiguousarray(ref, dtype=np.int32)
    out = np.empty((h, w), np.int32)
    _LIB.vte_dmvr_padded_mc(
        _i32p(r), ph, pw, x, y, w, h, int(merge_mv[0]), int(merge_mv[1]),
        int(refined_mv[0]), int(refined_mv[1]), comp_scale, bit_depth,
        pic_w, pic_h, ctu_size, 1 if intermediate else 0,
        1 if alt_hpel else 0, _i32p(out))
    return out


def mctf_interp(plane, tapsh, tapsv, o0, pad, bit_depth):
    """MCTF whole-plane fractional interpolation (mctf.py
    _interp_plane_mctf as one C++ pass); returns the pad-padded plane."""
    _alf_setup()
    h, w = plane.shape
    p = np.ascontiguousarray(plane, dtype=np.int32)
    th = np.ascontiguousarray(tapsh, dtype=np.int32)
    tv = np.ascontiguousarray(tapsv, dtype=np.int32)
    out = np.empty((h + 2 * pad, w + 2 * pad), np.int32)
    _LIB.vte_mctf_interp(_i32p(p), h, w, _i32p(th), _i32p(tv), len(th),
                         o0, pad, bit_depth, _i32p(out))
    return out


def mctf_block_ssd(plane, cur_blocks, bxy, mvq, bs, bit_depth):
    """Per-block SSD at 1/16-pel MVs on the virtual interp plane
    (mctf.py _ssd_blocks without materializing per-phase planes)."""
    _alf_setup()
    h, w = plane.shape
    p = np.ascontiguousarray(plane, dtype=np.int32)
    c = np.ascontiguousarray(cur_blocks, dtype=np.int32)
    b = np.ascontiguousarray(bxy, dtype=np.int32)
    m = np.ascontiguousarray(mvq, dtype=np.int32)
    n = len(m)
    out = np.empty(n, np.int64)
    _LIB.vte_mctf_block_ssd(_i32p(p), h, w, n, _i32p(b), _i32p(m), bs,
                            _i32p(c), bit_depth, _i32p(out))
    return out


def mctf_mc_plane(ref, mvq, bs, scale, taps8, bit_depth):
    """Whole-plane per-block MC at 1/16-pel MVs (mctf.py
    _mc_block_plane in one C++ call)."""
    _alf_setup()
    h, w = ref.shape
    r = np.ascontiguousarray(ref, dtype=np.int32)
    m = np.ascontiguousarray(mvq, dtype=np.int32)
    nby, nbx = mvq.shape[:2]
    out = np.empty((h, w), np.int32)
    _LIB.vte_mctf_mc_plane(_i32p(r), h, w, _i32p(m), nby, nbx, bs,
                           scale, 1 if taps8 else 0, bit_depth,
                           _i32p(out))
    return out


def mctf_block_me(cur, ref, bs, rng, init_mv):
    """MCTF per-block integer full search (mctf.py _block_me)."""
    _alf_setup()
    h, w = cur.shape
    nby, nbx = (h + bs - 1) // bs, (w + bs - 1) // bs
    c = np.ascontiguousarray(cur, dtype=np.int32)
    r = np.ascontiguousarray(ref, dtype=np.int32)
    iv = np.ascontiguousarray(init_mv, dtype=np.int32)
    mv = np.empty((nby, nbx, 2), np.int32)
    err = np.empty((nby, nbx), np.int64)
    _LIB.vte_mctf_block_me(_i32p(c), _i32p(r), h, w, bs, rng, _i32p(iv),
                           _i32p(mv), _i32p(err))
    return mv, err


def sao_stats(rec, orig, bit_depth, cs, n_cols, n_rows):
    """Per-CTU SAO statistics for one component plane (encoder/sao_enc.py
    _picture_stats as one C++ pass): returns (eo_cnt, eo_err
    [4, n_ctus, 5], bo_cnt, bo_err [n_ctus, 32]) int64.  Category 0 of
    the EO stats is not meaningful (borders excluded natively)."""
    _alf_setup()
    h, w = rec.shape
    r = np.ascontiguousarray(rec, dtype=np.int32)
    o = np.ascontiguousarray(orig, dtype=np.int32)
    n_ctus = n_cols * n_rows
    eo_cnt = np.zeros((4, n_ctus, 5), np.int64)
    eo_err = np.zeros((4, n_ctus, 5), np.int64)
    bo_cnt = np.zeros((n_ctus, 32), np.int64)
    bo_err = np.zeros((n_ctus, 32), np.int64)
    _LIB.vte_sao_stats(_i32p(r), _i32p(o), h, w, cs, n_cols, bit_depth,
                       _i32p(eo_cnt), _i32p(eo_err), _i32p(bo_cnt),
                       _i32p(bo_err))
    return eo_cnt, eo_err, bo_cnt, bo_err


def alf_stats(rec, orig, bit_depth, ctu_size, cls=None, trn=None,
              n_clip=1):
    """Per-class clipped-Wiener statistics (encoder/alf_enc.py Gram
    accumulation as one C++ pass).  Luma when cls/trn given (25 classes,
    12 transpose-mapped taps), chroma otherwise (1 class, 6 taps).
    Returns (A [n_classes, n_clip*n_taps, n_clip*n_taps] float64,
    b [n_classes, n_clip*n_taps] float64), integer-exact."""
    _alf_setup()
    h, w = rec.shape
    r = np.ascontiguousarray(rec, dtype=np.int32)
    o = np.ascontiguousarray(orig, dtype=np.int32)
    is_chroma = cls is None
    n_taps = 6 if is_chroma else 12
    n_classes = 1 if is_chroma else 25
    dim = n_clip * n_taps
    A = np.empty((n_classes, dim, dim), np.float64)
    b = np.empty((n_classes, dim), np.float64)
    if is_chroma:
        cp = tp = 0
        cls_w = 0
    else:
        c = np.ascontiguousarray(cls, dtype=np.int32)
        t = np.ascontiguousarray(trn, dtype=np.int32)
        cp, tp, cls_w = _i32p(c), _i32p(t), c.shape[1]
    _LIB.vte_alf_stats(_i32p(r), _i32p(o), h, w, bit_depth, ctu_size,
                       1 if is_chroma else 0, cp, tp, cls_w, n_clip,
                       _i32p(A), _i32p(b))
    return A, b


_DQ_READY = False


def _dq_setup():
    global _DQ_READY
    if _DQ_READY or _LIB is None:
        return _LIB is not None
    _LIB.vte_depquant.argtypes = [
        _PI32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        _PU16, _PU16, _PI32]
    _LIB.vte_depquant.restype = ctypes.c_int
    _DQ_READY = True
    return True


def depquant(coeff, qp, bit_depth, is_luma, lmbda, ctx, cbf_ctx_id=None,
             thr_val=8):
    """Native dependent-quantization trellis (ops/depquant.py port,
    bit-exact); returns signed levels [h, w] int32."""
    _dq_setup()
    h, w = coeff.shape
    c = np.ascontiguousarray(coeff, dtype=np.int32)
    out = np.zeros((h, w), dtype=np.int32)
    _LIB.vte_depquant(
        _i32p(c), w, h, qp, bit_depth, 1 if is_luma else 0, float(lmbda),
        -1 if cbf_ctx_id is None else int(cbf_ctx_id), thr_val,
        _u16p(ctx.state0), _u16p(ctx.state1), _i32p(out))
    return out


def _dq2_setup():
    if getattr(_dq2_setup, "done", False) or _LIB is None:
        return _LIB is not None
    _LIB.vte_dequant_dq.argtypes = [_PI32] + [ctypes.c_int] * 5 + [_PI32]
    _LIB.vte_dequant_dq.restype = None
    _LIB.vte_build_refs_isp.argtypes = [
        _PI32] + [ctypes.c_int] * 6 + [_PU8] + [ctypes.c_int] * 11 + \
        [_PI32, _PI32]
    _LIB.vte_build_refs_isp.restype = None
    _dq2_setup.done = True
    return True


def dequant_dq(qc, qp, bit_depth):
    """Dependent-quantization dequant (ops/transforms.py dequant_dq_np
    port: 2-quantizer state machine over the scan)."""
    _dq2_setup()
    h, w = qc.shape
    c = np.ascontiguousarray(qc, dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    _LIB.vte_dequant_dq(_i32p(c), w, h, qp, bit_depth, 1, _i32p(out))
    return out


def build_refs_isp(rec, x, y, w, h, coded_mask, unit, bit_depth,
                   pred_sizes, cu_x, cu_y, cu_w, cu_h, isp_mode):
    """Reference builder with the ISP partition availability rule."""
    _dq2_setup()
    ph, pw = rec.shape
    cuh, cuw = coded_mask.shape
    psz = pred_sizes[0] if pred_sizes else -1
    phs = pred_sizes[1] if pred_sizes else -1
    eff_ps = psz if psz > 0 else 2 * w
    eff_hs = phs if phs > 0 else 2 * h
    top = np.empty(eff_ps + 3, dtype=np.int32)
    left = np.empty(eff_hs + 3, dtype=np.int32)
    r = np.ascontiguousarray(rec, dtype=np.int32)
    c = coded_mask.view(np.uint8) if coded_mask.dtype == np.bool_ \
        and coded_mask.flags.c_contiguous \
        else np.ascontiguousarray(coded_mask, dtype=np.uint8)
    _LIB.vte_build_refs_isp(_i32p(r), ph, pw, x, y, w, h, _u8p(c), cuh,
                            cuw, unit, bit_depth, psz, phs, cu_x, cu_y,
                            cu_w, cu_h, isp_mode, _i32p(top), _i32p(left))
    return top, left


def predict_mip(top, left, w, h, mode, transposed, bit_depth):
    """One MIP prediction (ops/mip.py predict_mip port)."""
    t = np.ascontiguousarray(top[:w], dtype=np.int32)
    l = np.ascontiguousarray(left[:h], dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    _LIB.vte_predict_mip(_i32p(t), _i32p(l), w, h, mode,
                         1 if transposed else 0, bit_depth, _i32p(out))
    return out


def predict_mip_all(top, left, w, h, bit_depth, n_modes):
    """All (mode, transpose) MIP predictions: (n_modes, 2, h, w)."""
    t = np.ascontiguousarray(top[:w], dtype=np.int32)
    l = np.ascontiguousarray(left[:h], dtype=np.int32)
    out = np.empty((n_modes, 2, h, w), dtype=np.int32)
    _LIB.vte_predict_mip_all(_i32p(t), _i32p(l), w, h, bit_depth,
                             _i32p(out))
    return out


def _mc_setup():
    if getattr(_mc_setup, "done", False) or _LIB is None:
        return _LIB is not None
    from ..ops.intra import CHROMA_FILTER
    _LIB.vte_mc_init.argtypes = [_PI32]
    _LIB.vte_mc_block.argtypes = [_PI32] + [ctypes.c_int] * 12 + \
        [_PI32, _PI32]
    _LIB.vte_mc_block.restype = None
    _LIB.vte_dmvr_padded_mc.argtypes = [_PI32] + [ctypes.c_int] * 17 + \
        [_PI32]
    _LIB.vte_dmvr_padded_mc.restype = None
    _LIB.vte_dmvr_bi_subpu.argtypes = [_PI32, _PI32] + \
        [ctypes.c_int] * 18 + [_PI32]
    _LIB.vte_dmvr_bi_subpu.restype = None
    ct_ = np.ascontiguousarray(CHROMA_FILTER, dtype=np.int32)
    _LIB.vte_mc_init(ct_.ctypes.data)
    _mc_setup.done = True
    return True


def mc_block(ref_plane, x, y, w, h, mv_x, mv_y, bit_depth, is_luma,
             intermediate, alt_hpel, taps_override=None):
    """Native MC interpolation (ops/interp.py mc_block_np port).
    taps_override: per-phase table [16, 8] (affine 6-tap filter)."""
    _mc_setup()
    ph, pw = ref_plane.shape
    out = np.empty((h, w), dtype=np.int32)
    to = 0
    if taps_override is not None:
        t8 = np.ascontiguousarray(taps_override, dtype=np.int32)
        assert t8.shape == (16, 8), "taps_override must be [16, 8]"
        to = t8.ctypes.data
        keep = t8  # noqa: F841 (lifetime)
    _LIB.vte_mc_block(_i32p(ref_plane), ph, pw, x, y, w, h, mv_x, mv_y,
                      bit_depth, 1 if is_luma else 0,
                      1 if intermediate else 0, 1 if alt_hpel else 0,
                      to, _i32p(out))
    return out


def dmvr_refine_core(bl0, bl1, w, h, pad):
    """Native DMVR 25-point search (ops/dmvr.py dmvr_refine core).
    Returns int32 [n_subs, 3] rows {dx, dy, bdof_ok} over the sub-PU
    grid in row-major order."""
    if not getattr(dmvr_refine_core, "ready", False):
        _LIB.vte_dmvr_refine.argtypes = [_PI32, _PI32] + \
            [ctypes.c_int] * 3 + [_PI32]
        _LIB.vte_dmvr_refine.restype = None
        dmvr_refine_core.ready = True
    dy_ = min(h, 16)
    dx_ = min(w, 16)
    n = ((h + dy_ - 1) // dy_) * ((w + dx_ - 1) // dx_)
    out = np.empty((n, 3), np.int32)
    b0 = np.ascontiguousarray(bl0, dtype=np.int32)
    b1 = np.ascontiguousarray(bl1, dtype=np.int32)
    _LIB.vte_dmvr_refine(_i32p(b0), _i32p(b1), w, h, pad, _i32p(out))
    return out
