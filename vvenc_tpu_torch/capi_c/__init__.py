"""The port's C API library and its example client.

vvenc_tpu_torch_capi.cpp is a shim that embeds CPython and drives
vvenc_tpu_torch.capi; it exports the symbols declared in this
directory's header, a copy of the repository's C API header (capi/).
client.c is a pure-C client of that header.  build() compiles both with g++ / gcc against the running
interpreter's libpython into vvenc_tpu_torch/_build/capi/ at first use;
run_client() runs the client with the environment the embedded
interpreter needs to import the port.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import sysconfig

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build" / "capi"


def python_link():
    """(include dir, library dir, library name) of the running
    interpreter's libpython; raises when the interpreter cannot be
    embedded (no shared libpython)."""
    libdir = sysconfig.get_config_var("LIBDIR")
    name = f"python{sys.version_info.major}.{sys.version_info.minor}" \
        f"{getattr(sys, 'abiflags', '')}"
    if not sysconfig.get_config_var("Py_ENABLE_SHARED") or not libdir or \
            not (pathlib.Path(libdir) / f"lib{name}.so").exists():
        raise RuntimeError(
            f"this Python cannot be embedded: Py_ENABLE_SHARED="
            f"{sysconfig.get_config_var('Py_ENABLE_SHARED')}, no "
            f"lib{name}.so in {libdir}")
    return sysconfig.get_paths()["include"], libdir, name


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{cmd[0]} failed ({r.returncode}):\n"
                           f"{r.stderr[-4000:]}")


def build():
    """(library, client) paths, compiling what is not built yet."""
    inc, libdir, name = python_link()
    sources = sorted(p for p in HERE.iterdir()
                     if p.suffix in (".c", ".cpp", ".h"))
    tag = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                         + f"{inc}{libdir}{name}".encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libvvenc_tpu_torch_capi-{tag}.so"
    exe = BUILD_DIR / f"client-{tag}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{pid}.tmp")
        _run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{inc}",
              f"-I{HERE}", str(HERE / "vvenc_tpu_torch_capi.cpp"),
              f"-L{libdir}", f"-l{name}", "-o", str(tmp)])
        os.replace(tmp, so)
    if not exe.exists():
        tmp = exe.with_name(f"{exe.name}.{pid}.tmp")
        _run(["gcc", "-O2", f"-I{HERE}", str(HERE / "client.c"), str(so),
              f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{BUILD_DIR}",
              f"-Wl,-rpath,{libdir}", "-o", str(tmp)])
        os.replace(tmp, exe)
    return so, exe


def client_frames(w: int, h: int, n: int):
    """The pictures client.c encodes: [(Y, U, V)] uint8."""
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    out = []
    for t in range(n):
        y = ((r * 2 + c * 3 + t * 16) & 0xFF).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + 8 * t, np.uint8)
        v = np.full((h // 2, w // 2), 160 - 8 * t, np.uint8)
        out.append((y, u, v))
    return out


def run_client(out_path, params: str, w: int, h: int, frames: int,
               timeout: float = 900.0) -> subprocess.CompletedProcess:
    """Builds the library and the client if needed and runs the client:
    it encodes `frames` pictures of w x h through the C API into
    out_path.  The embedded interpreter finds the port through
    PYTHONPATH (the repository root and the directories that hold numpy
    and torch)."""
    import torch
    _, exe = build()
    paths = [str(HERE.parents[1])] + [
        str(pathlib.Path(m.__file__).resolve().parents[1])
        for m in (np, torch)]
    old = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        paths + ([old] if old else [])))
    return subprocess.run([str(exe), str(out_path), params, str(w), str(h),
                           str(frames)], env=env, capture_output=True,
                          text=True, timeout=timeout)
