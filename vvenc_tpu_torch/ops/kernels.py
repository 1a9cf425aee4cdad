"""Build, load and count the port's CUDA kernels (vvenc_tpu_torch/csrc).

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled by
nvcc for Hopper (sm_90a) into a shared library under
vvenc_tpu_torch/_build/kernels/ at first use and loaded with ctypes.  The
library name carries a hash of the source, of every shared device header
(csrc/*.cuh, which a source may include) and of the flags, so an edited
source or header rebuilds.  build() starts one nvcc per missing source,
all at once.

-fmad=false: the f32 cost arithmetic of plan_trial must round each
product and sum on its own, as the reference's XLA program does; a
contracted FMA would move near-tie decisions (the native host build uses
-ffp-contract=off for the same reason).

launches[entry] counts the launches of each kernel entry (a source may
hold several: ENTRIES maps each entry to its source); each wrapper adds
one (count(entry)) where it launches its kernel, and nowhere else.  The
encoder launches from several threads (frame-parallel pictures, WPP,
mesh positions), so the count takes a lock.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build" / "kernels"
# launch-counted kernel entries -> the csrc/<source>.cu that holds them
ENTRIES = {
    "intra_pred_all": "intra_pred_all",
    "satd_modes": "satd_modes",
    "plan_trial": "plan_trial",                # K1's predictions
    "plan_trial_refs": "plan_trial",           # the references (planning)
    "presel_costs": "presel_costs",            # plane form (FramePresel)
    "presel_costs_gathered": "presel_costs",   # the reference's inputs
    "frame_me": "frame_me",
    "fwd_transform_batch": "transform_batch",
    "inv_transform_batch": "transform_batch",
    "quant_batch": "quant_batch",
    "dequant_batch": "quant_batch",
    "mc_batch": "mc_batch",
    "full_search_sse": "full_search",
    "sse_batch": "dist_batch",
    "sad_batch": "dist_batch",
    "satd_batch": "dist_batch",
    "mode_costs": "mode_costs",
}
SOURCES = tuple(dict.fromkeys(ENTRIES.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

launches = dict.fromkeys(ENTRIES, 0)
_LIBS: dict = {}
_FUNCTIONS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        for k in launches:
            launches[k] = 0


def count(entry: str) -> None:
    """One launch of kernel entry `entry` (called by its wrapper after
    the launch)."""
    with _LOCK:
        launches[entry] += 1


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def so_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    tag = hashlib.sha256(h.digest() + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named kernels that are not built yet (one nvcc process
    per source, all started together); returns {name: ptxas report}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for n in names:
            so = so_path(n)
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                tmp, so)
        failed = []
        for n, (proc, tmp, so) in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed for csrc/{n}.cu:\n{err}")
                continue
            so.with_suffix(".log").write_text(out + err)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    return {n: so_path(n).with_suffix(".log").read_text() for n in names
            if so_path(n).with_suffix(".log").exists()}


def function(name: str, symbol: str, argtypes):
    """ctypes function `symbol` of kernel library `name` (a source; built
    and loaded on first use); returns cudaError_t as an int.  Looked up
    once for each (name, symbol, argtypes) and kept, so that a wrapper
    pays a dictionary lookup a launch."""
    key = (name, symbol, tuple(argtypes))
    fn = _FUNCTIONS.get(key)
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(so_path(name)))
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p
        fn = lib[symbol]        # an object of its own for these argtypes
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch from library `name` (a source) was refused
    (cudaGetLastError() != 0)."""
    if err:
        msg = _LIBS[name].vt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name}: error {err} ({msg})")


RESOURCE_KEYS = ("registers", "static_smem", "dynamic_smem", "threads",
                 "blocks_per_sm", "local_bytes")


def resources(name: str, symbol: str, *args: int) -> dict:
    """The resources of a kernel of source `name` as its C query `symbol`
    (a vt_*_attrs function taking ints, then an int[6]) reports them:
    RESOURCE_KEYS -> int (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card)."""
    fn = function(name, symbol, [ctypes.c_int] * len(args)
                  + [ctypes.c_void_p])
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    check(name, fn(*args, ctypes.addressof(out)))
    return dict(zip(RESOURCE_KEYS, out))


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Raise unless tensor t has the dtype, rank and device the kernel
    takes and is C-contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: {t.dtype} rank {t.dim()}, expected "
                         f"{dtype} rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
