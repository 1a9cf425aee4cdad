"""The port's graft entry points (vvenc_tpu_torch.graft_entry), on the
CPU: entry() computes what the JAX package's entry() computes, bit-exact,
and dryrun_multichip passes on an 8-position CPU mesh (its e2e check
needs the native library and raises without it)."""

import numpy as np
import pytest

from vvenc_tpu_torch import graft_entry, native


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as J
    jfn, jargs = J.entry()
    fn, args = graft_entry.entry(device="cpu")
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), b)
    assert all(a.device.type == "cpu" for a in args)
    np.testing.assert_array_equal(fn(*args).numpy(), np.asarray(jfn(*jargs)))


def test_dryrun_multichip_on_eight_cpu_positions(capsys):
    if not native.available():
        pytest.skip("native library unavailable (no g++)")
    graft_entry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "8 positions (gops 4 x tiles 2) on the CPU" in out
    assert "byte-identical" in out and "dryrun_multichip ok" in out


def test_dryrun_raises_without_the_native_library(monkeypatch):
    """The reference prints "skipped" for its e2e check when the native
    library is missing; the port's dry run raises."""
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native library"):
        graft_entry.dryrun_multichip(2, device="cpu")
