"""The port (vvenc_tpu_torch) stands alone: it imports neither jax nor the
JAX package, and its entry points run on the card unless the caller asks
for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vvenc_tpu_torch.config import VvencTpuConfig, check_config
from vvenc_tpu_torch.device import resolve_device
from vvenc_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vvenc_tpu_torch"
_FOREIGN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|vvenc_tpu)(\.|\s|$)")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")


def test_import_closure_has_no_jax_and_no_vvenc_tpu():
    code = (
        "import sys\n"
        "import vvenc_tpu_torch, vvenc_tpu_torch.__main__\n"
        "import vvenc_tpu_torch.ops.intra_plan, vvenc_tpu_torch.native\n"
        "import vvenc_tpu_torch.decoder, vvenc_tpu_torch.ops.tables\n"
        "import vvenc_tpu_torch.ops.rdoq, vvenc_tpu_torch.ops.depquant\n"
        "import vvenc_tpu_torch.encoder.filmgrain\n"
        "import vvenc_tpu_torch.tools, vvenc_tpu_torch.tools.bdrate\n"
        "import vvenc_tpu_torch.tools.calibrate_plan\n"
        "import vvenc_tpu_torch.bench\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'vvenc_tpu'))\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_source_imports_no_jax_and_no_vvenc_tpu(path):
    for n, line in enumerate((PKG / path).read_text().splitlines(), 1):
        assert not _FOREIGN.match(line), f"{path}:{n}: {line.strip()}"
        assert "vvenc_tpu." not in line.replace("vvenc_tpu_torch", ""), \
            f"{path}:{n}: {line.strip()}"


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    assert EncoderConfig().device == "cuda"
    assert VvencTpuConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        IntraEncoder(EncoderConfig(width=64, height=64))
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    from vvenc_tpu_torch.ops.intra_plan import build_plans
    src = np.zeros((64, 64), np.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        build_plans([src], 10, 64, 8, 37, [10.0], [3.0])


def test_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    _no_card()
    from vvenc_tpu_torch.__main__ import main, parse_args
    assert parse_args(["-i", "x", "-o", "y", "-s", "64x64"]).device == "cuda"
    clip = tmp_path / "c.yuv"
    clip.write_bytes(bytes(64 * 64 * 3 // 2))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-i", str(clip), "-o", str(tmp_path / "o.266"), "-s", "64x64",
              "-f", "1", "--preset", "faster", "--intra-period", "1"])


def test_device_names_are_checked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    cfg = VvencTpuConfig(width=64, height=64, device="tpu")
    with pytest.raises(ValueError, match="device"):
        check_config(cfg)


@pytest.mark.parametrize("opt", [dict(intra_presel="source"),
                                 dict(me_mode="device")])
def test_unported_device_paths_raise(opt):
    """The frame-level preselection and the device ME, once refused as
    unported, are ported: on the CPU the encoder takes them (their plain
    versions), and on "cuda" without a card it raises instead of running
    another path."""
    enc = IntraEncoder(EncoderConfig(width=64, height=64, device="cpu",
                                     **opt))
    assert all(getattr(enc.cfg, k) == v for k, v in opt.items())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            IntraEncoder(EncoderConfig(width=64, height=64, **opt))


def test_inter_and_device_modules_import_no_jax_and_no_vvenc_tpu():
    """The modules of the random-access path and the two kernels of the
    second slice pull in neither jax nor the JAX package."""
    mods = ["ops.me", "ops.intra_presel", "ops.dmvr", "ops.bdof",
            "ops.affine_search", "codec.geo", "codec.affine", "codec.lmcs",
            "encoder.ifp", "encoder.lmcs_enc", "encoder.ratectrl",
            "encoder.lookahead", "encoder.inter_search", "ops.transforms",
            "parallel.mesh", "graft_entry"]
    code = ("import sys\n"
            + "".join(f"import vvenc_tpu_torch.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vvenc_tpu'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_mesh_and_dryrun_default_to_cuda_and_raise_without_a_card():
    """The mesh path's entry points run on the card unless asked for the
    CPU: make_mesh(), make_mesh2d(), graft_entry.entry() and
    dryrun_multichip() raise without one, and a position named "cuda"
    does too."""
    _no_card()
    from vvenc_tpu_torch import graft_entry
    from vvenc_tpu_torch.parallel import mesh as M
    for call in (M.make_mesh, M.make_mesh2d, graft_entry.entry,
                 lambda: graft_entry.dryrun_multichip(4),
                 lambda: M.make_mesh(["cuda"] * 2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert M.make_mesh(["cpu"] * 2).home == torch.device("cpu")


def test_mesh_hooks_keep_the_encoder_on_its_device():
    """A MESH of CPU positions does not take a "cuda" encode to the CPU:
    the hooks check the mesh's device against the encoder's."""
    from vvenc_tpu_torch.ops import intra_plan
    from vvenc_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(["cpu"] * 2)
    M.check_mesh_device(mesh, "cpu")
    with pytest.raises(ValueError, match="device"):
        M.check_mesh_device(mesh, "cuda")
    if not torch.cuda.is_available():
        intra_plan.MESH = mesh
        try:
            with pytest.raises(RuntimeError, match="cuda"):
                intra_plan.build_plans([np.zeros((64, 64), np.int32)], 10,
                                       64, 8, 37, [10.0], [3.0])
        finally:
            intra_plan.MESH = None


def test_fourth_slice_modules_import_no_jax_and_no_vvenc_tpu():
    """The batched programs of the fourth slice and the library entry
    points (api, capi, ffapp, the C shim's build helper) pull in neither
    jax nor the JAX package."""
    mods = ["ops.intra_batch", "ops.interp", "ops.rdcost", "ops.me", "api",
            "capi", "ffapp", "capi_c"]
    code = ("import sys\n"
            + "".join(f"import vvenc_tpu_torch.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vvenc_tpu'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_c_shim_drives_the_port_and_not_the_jax_package():
    src = (PKG / "capi_c" / "vvenc_tpu_torch_capi.cpp").read_text()
    assert 'PyImport_ImportModule("vvenc_tpu_torch.capi")' in src
    assert "vvenc_tpu.capi" not in src.replace("vvenc_tpu_torch.capi", "")
    # the same C symbols as the repository's header, so a client of
    # vvenc_tpu.h links against either library
    decl = re.compile(r"^\S.*\b(vvenc_tpu_\w+)\s*\(", re.M)
    ours = (PKG / "capi_c" / "vvenc_tpu.h").read_text()
    theirs = (ROOT / "capi" / "vvenc_tpu.h").read_text()
    assert decl.findall(ours) == decl.findall(theirs)
    assert len(decl.findall(ours)) == 9


def test_library_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from vvenc_tpu_torch.api import VVENC_ERR_INITIALIZE, VVEncImpl
    from vvenc_tpu_torch import capi
    impl = VVEncImpl()
    assert impl.init(VvencTpuConfig(width=64, height=64)) \
        == VVENC_ERR_INITIALIZE
    assert "cuda" in impl.last_error()
    with pytest.raises(ValueError, match="cuda"):
        capi.capi_open("width=64;height=64;qp=37;intra_period=1")
