"""Stub of the port's CUDA kernel loader: the reference runs only the
plain versions, so any attempt to launch a kernel raises."""

launches: dict = {}


def _no_kernels(*_a, **_k):
    raise RuntimeError("the benchmark's reference has no CUDA kernels: "
                       "pass CPU tensors")


count = function = check = resources = stream_ptr = require = _no_kernels
