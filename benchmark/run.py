"""Runs one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (also `python3 -m benchmark.run ...`).  The
cells, configurations and metrics are those of BENCHMARK.json; the
system under test is vvenc_tpu_torch, on one NVIDIA card.  With
--trace 0 the result's metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (torch.profiler over the window and the
port's PROF spans, VVENC_TPU_PROFILE=1).

Prints, last on standard error, each compared number beside its limit,
and last on standard output one JSON line: correct, attempted, failed,
metrics, device, (breakdown), info, checks.  Exits non-zero and prints no
result without a card, when the run fails, or when jax, jaxlib, flax or
the JAX package vvenc_tpu was imported.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# run as a script, the benchmark's own folder would come first on the
# path; the harness imports it as the package `benchmark` instead
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:] = [REPO] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vvenc_tpu")
# the program's build and kernel caches, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (vvenc_tpu_torch is not vvenc_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    try:
        return run(parse(argv))
    finally:
        stop_children()


def run(args) -> int:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(REPO, ".bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    if args.trace:
        os.environ["VVENC_TPU_PROFILE"] = "1"   # before the port's import
    import torch
    from benchmark import spec
    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"bench: FAIL: the cell needs {chips} CUDA "
                         f"device(s); torch.cuda.is_available() = "
                         f"{torch.cuda.is_available()}, device_count() = "
                         f"{torch.cuda.device_count()}\n")
        return 2
    from benchmark.harness import Run, run_cell
    run = Run(bench, args.workload, args.seed, args.seconds, args.trace)
    out = run_cell(run, T_START)
    out["card"] = card()
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"bench: FAIL: the run imported {bad}\n")
        return 3
    rows = out.pop("checks")
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        sys.stderr.write(f"check {n} = {v} (limit {lim})\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def card() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def children() -> list:
    """The processes whose parent is this one, from /proc."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                st = f.read()
        except OSError:
            continue
        # after the command's closing parenthesis: state, then ppid
        if int(st[st.rindex(")") + 2:].split()[1]) == me:
            out.append(int(d))
    return out


def stop_children(grace: float = 5.0) -> None:
    """Ends and waits for every child still there: what the run starts
    it waits for itself, so one found here is a fault, named on
    standard error."""
    import signal
    left = children()
    for pid in left:
        sys.stderr.write(f"bench: child process {pid} was still there at "
                         "the end of the run; stopping it\n")
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + grace
    for pid in left:
        try:
            while os.waitpid(pid, os.WNOHANG)[0] == 0:
                if time.time() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())
