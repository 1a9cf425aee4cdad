"""Nothing the harness imports is jax, jaxlib, flax or the JAX package
vvenc_tpu, by whole top-level name (vvenc_tpu_torch begins with
vvenc_tpu and is allowed)."""

import pathlib
import subprocess
import sys

from benchmark.run import forbidden_modules

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_forbidden_names_are_whole_top_level_names():
    names = ["vvenc_tpu_torch", "vvenc_tpu_torch.ops", "jaxtyping",
             "vvenc_tpu.ops", "jaxlib.xla", "flax", "numpy"]
    assert forbidden_modules(names) == ["flax", "jaxlib.xla",
                                        "vvenc_tpu.ops"]


def test_a_run_imports_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from benchmark.tests.tiny import tiny_run\n"
        "from benchmark.run import forbidden_modules\n"
        "for kind in ('ai', 'ra'):\n"
        "    tiny_run(kind, seconds=0.5)\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
