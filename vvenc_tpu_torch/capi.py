"""Python side of the C API bridge (capi_c/vvenc_tpu_torch_capi.cpp).

The C library embeds CPython and calls these functions; handles are
integers indexing a registry.  Mirrors the reference's C API lifecycle
(vvenc.h.in: create/open/encode(+NULL flush)/close) through the
VVEncImpl state machine (api.py).  The encoder runs on the card unless
the params string asks for the CPU ("device=cpu", set through set_param
as every other field)."""

from __future__ import annotations

import numpy as np

from .api import VVEncImpl, VVENC_OK
from .config.config import VvencTpuConfig, Preset, init_preset, set_param

_handles = {}
_next_id = 1


def capi_open(params: str) -> int:
    """params: semicolon-separated key=value pairs; must include
    width/height.  'preset=<name>' applies a preset first.  Returns a
    handle (>0) or raises."""
    cfg = VvencTpuConfig()
    preset = None
    kv = []
    for tok in params.split(";"):
        tok = tok.strip()
        if not tok:
            continue
        k, _, v = tok.partition("=")
        if k.strip().lower() == "preset":
            preset = Preset[v.strip().upper()]
        else:
            kv.append((k.strip(), v.strip()))
    if preset is not None:
        init_preset(cfg, preset)
    for k, v in kv:
        set_param(cfg, k, v)
    impl = VVEncImpl()
    rc = impl.init(cfg)
    if rc != VVENC_OK:
        raise ValueError(f"init failed ({rc}): {impl.last_error()}")
    global _next_id
    h = _next_id
    _next_id += 1
    _handles[h] = (impl, cfg)
    return h


def capi_encode(handle: int, y: bytes, u: bytes, v: bytes) -> bytes:
    """Encode one frame (8-bit planar 4:2:0) -> Annex-B AU bytes
    (possibly empty while the GOP buffers, like the reference)."""
    impl, cfg = _handles[handle]
    w, h = cfg.width, cfg.height
    yp = np.frombuffer(y, np.uint8).reshape(h, w)
    up = np.frombuffer(u, np.uint8).reshape(h // 2, w // 2)
    vp = np.frombuffer(v, np.uint8).reshape(h // 2, w // 2)
    au, _done, rc = impl.encode((yp, up, vp))
    if rc != VVENC_OK:
        raise RuntimeError(f"encode failed ({rc}): {impl.last_error()}")
    return au


def capi_flush(handle: int) -> bytes:
    """NULL-picture flush: drain the buffered GOP tail."""
    impl, _cfg = _handles[handle]
    au, _done, rc = impl.encode(None)
    if rc != VVENC_OK:
        raise RuntimeError(f"flush failed ({rc}): {impl.last_error()}")
    return au


def capi_close(handle: int) -> None:
    entry = _handles.pop(handle, None)
    if entry is not None:
        entry[0].close()


def capi_version() -> str:
    from .api import version
    return version()


def capi_get_headers(handle: int) -> bytes:
    """Parameter-set NALs without encoding (vvenc_get_headers analog)."""
    impl, _cfg = _handles[handle]
    return impl.get_headers()


def capi_reconfig(handle: int, params: str) -> int:
    """Apply changed key=value pairs; 0 = OK, -11 = restart required
    (vvenc_reconfig analog)."""
    import copy
    impl, cfg = _handles[handle]
    cfg2 = copy.deepcopy(cfg)
    for tok in params.split(";"):
        tok = tok.strip()
        if not tok:
            continue
        k, _, v = tok.partition("=")
        set_param(cfg2, k.strip(), v.strip())
    rc = impl.reconfig(cfg2)
    return int(rc)


def capi_init_pass(handle: int, pass_no: int, stats_fname: str) -> int:
    """Two-pass rate control pass switch (vvenc_init_pass analog)."""
    impl, _cfg = _handles[handle]
    return int(impl.init_pass(pass_no, stats_fname))


def capi_take_recons(handle: int):
    """Newly reconstructed pictures since the last call ->
    [(poc, w, h, y_le16, u_le16, v_le16)] (10-bit little-endian planar;
    the rec-YUV callback source, vvenc.h.in:286-296)."""
    impl, cfg = _handles[handle]
    out = []
    for poc, rec in impl.take_recons():
        y = np.ascontiguousarray(rec[0], np.uint16).tobytes()
        u = np.ascontiguousarray(rec[1], np.uint16).tobytes()
        v = np.ascontiguousarray(rec[2], np.uint16).tobytes()
        out.append((poc, cfg.width, cfg.height, y, u, v))
    return out
