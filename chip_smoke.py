#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vvenc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH] [--old-csrc DIR]   # repo root, one card

Phases; any mismatch or error ends the run with a non-zero exit code:

1. Requires torch.cuda.is_available(); prints the card's name and power
   limit (nvidia-smi).
2. Builds the eleven CUDA kernel sources (csrc/*.cu, one nvcc per
   source, all started together), the native host library
   (native/entropy.cpp, g++) and the C shim with its C client
   (capi_c/, g++ against libpython), and prints the build seconds.
3. Holds each kernel against its plain PyTorch version on the card:
   - device planning's route (the fused 67-mode SATD, K4's gathered
     entry presel_costs, then K3's reference entry plan_trial_refs, which
     predicts its own survivors) beside K1 (intra_pred_all) -> K2
     (satd_modes) -> K3 (plan_trial), the route before it, on 4 smooth
     1920x1080 luma frames at 8 and at 10 bits, every plan class 4..64:
     K1 and K2 bit-exact, the fused SATD bit-exact to K2(K1(...)), both
     K3 entries' modes equal and costs within rtol 1e-5, and the plan
     tables of each route (mode0, mode1, split after the PLAN_MARGIN
     drop and the quadtree DP) equal to the plain versions', a flip
     being allowed only at a near-tie (relative gap < 1e-5; flips are
     counted and printed).  Times per class at 1080p, on config 1's one
     10-frame plan batch and on one of its pictures (the streaming
     encode's plan): the call (CUDA events) of every kernel and, for K4's
     gathered entry and both K3 entries, the device time of a call warm
     and after an L2 flush (call_device_ms); then build_plans on config
     1's batch and 1080p
     faster's through both routes in turns: times, the peak of
     torch.cuda.max_memory_allocated, plan tables equal.
   - K4 (presel_costs) bit-exact on one 1920x1080 10-bit picture over
     all 23 MTT classes, and on an 832x480 8-bit crop; times it per
     class and per picture (all classes into one buffer; the picture's
     device time too, warm and cold), the one fetch
     of the picture's costs apart (pinned and pageable), and a whole
     FramePresel (upload, launches, fetch).
   - The resources of K3's (both entries) and K4's kernels per class:
     registers, static and dynamic shared memory, threads and resident
     blocks per SM (each source's vt_*_attrs query).
   - K4's gathered entry (presel_costs, the reference's inputs) on the
     same picture and classes: bit-exact against the plain version and
     equal to the plane form; timed per class.
   - K1 and K2 bit-exact against their plain versions (10-bit) and timed
     (the public call, CUDA events; the kernel's device time of one
     call, profiler) at search_step's shape (the 4 16x16 blocks of one
     position of dryrun_multichip(4); 2000 calls), on the QT grid of
     every square class 4..64, 8x4 and 16x8 of a 1920x1080 picture, and
     on each class of config 1's plan batch.
   - K5 (frame_me) on two 1920x1080 and two 832x480 pictures at R = 64,
     8 and 10 bits: MVs and costs equal; timed at 10 bits.
   - The resources of K5's kernel, of K11's per block size, of K6's
     (both entries) per class, of K9's at its three timed shapes and of
     K1's and K2's per class.
   - K6 (fwd/inv_transform_batch) and K7 (quant/dequant_batch) bit-exact
     on the residuals of 1920x1080 pictures (source minus search_step's
     chosen prediction) for every square class 4..64 plus 8x4 and 16x8,
     at 8 and 10 bits, QPs 22, 37, 51 and both slice types; timed per
     class at 10 bits, QP 37, intra, each with the device time of a
     call (call_device_ms; at 16x16 also cold); K6 also bit-exact and
     timed at search_step's shape (4 blocks of 16x16).
   - K8-K11 through their public functions at 1080p shapes, each first
     in a path run (the full-width calls at 10 bits, the launch counts
     set to 0 just before and read just after), then against its plain
     version at 8 and 10 bits: K8 mc_batch bit-exact on the windows of
     every 16x16 block of a second picture at the 16 quarter-pel phases
     and on the 8x8 blocks of a 960x540 plane at five 1/32 phases; K9
     full_search_sse_batch integer SSEs and argmins equal on the 1080p
     16x16 grid at R = 16 (B = 8,040), the 8x8 grid at R = 8 (B =
     32,400) and the 64x64 grid at R = 16 (B = 480), each timed; K10
     sse/sad bit-exact on the 1080p 4x4, 8x8, 16x16 and 64x64 grids
     (B = 129,600, 32,400, 8,040 and 480) and satd at [8040, 16, 16]
     (tiles 4, 8 and 16) and [480, 64, 64] (tiles 4, 8 and 64); K8 timed
     per kind (copy, horizontal, vertical, both) at luma 16x16 and
     chroma 8x8 and at each luma phase, K10 sse and sad per grid and
     satd per tile (the device time of a call beside each, warm and
     cold); K11 mode_costs_batch bit-exact on
     the 1080p 16x16 and 32x32 grids and the 416x240 4x4, 8x8 and 64x64
     grids (8-bit: 416x240, every size), build_ref_mains (host) timed
     apart.  Times at 10 bits.
4. The main paths, each through vvenc_tpu_torch.__main__.main with
   --device cuda --verify, the launch counts set to 0 just before and
   read just after, the port's decoder giving back every picture of the
   encoder's reconstruction; prints fps and the launches:
   - config 1 (all-intra 416x240 8-bit, 10 frames, QP 37, --preset
     faster --intra-period 1): device_rd must resolve to "on", the fused
     SATD and K3's reference entry launch and every plan is consumed;
     in this and every other encode of this phase K1, K2 and the
     preds-form K3 must not launch;
   - the same at 1920x1080, 4 frames;
   - 1920x1080 all-intra --preset medium, 2 frames: intra_presel must
     resolve to "source" and K4 launch;
   - config 2 (832x480, 17 frames, QP 37, --gop-size 8 --intra-period 0
     --preset faster) and config 3 cut to 3 frames (1920x1080, QP 32,
     --preset medium --gop-size 2 --intra-period 0 --qpa 1 --wpp
     --threads 2), both with --set me_mode=device: K5 must launch;
   - the tool twins (vvenc_tpu_torch.tools) on config 1's clip:
     calibrate_plan's encodes (a process each, all six at once, --device
     cuda) of the variants exact and plan-default at QPs 32, 37 and 42,
     every summary line parsed, both curves and their bd_delta printed;
     bdrate's
     run_ours at QP 37 bit-exact to config 1's CLI stream above; bdrate
     without a reference encoder must raise naming the path;
   - the bench twin's (vvenc_tpu_torch.bench) config-1 stage on config
     1's clip: its warm encode with --verify, then 3 timed passes; the
     median pass's rate above 0, the fused SATD and K3's reference
     entry launched in it, and the passes' stream config 1's CLI stream
     above; its record printed on a line of its own (phase 4: bench
     twin);
   - the library entry points: VVEncImpl streaming config 1's options
     (the fused SATD and K3's reference entry must launch in its
     window) and config 2's with
     me_mode=device (K5 must launch), each equal to the batch encoder
     of the same options and decoded; ffapp.main on a .cfg file of
     config 1's options equal to the CLI's stream; the C shim driven by
     its C client in a process of its own (two 416x240 pictures), equal
     to the Python C API path and decoded;
   - the mesh path, on a 2x2 mesh of 4 positions spread over the visible
     cards (several on one card, each on its own stream, when there are
     fewer cards; the run prints how many): search_step on the 1080p
     16x16 and 64x64 grids equal to its plain route, sharded_presel_costs
     equal to the unsharded run on all 23 MTT classes of a 1080p picture,
     sharded_encode_step2d on two 1080p pictures (16x16, G = 2, T = 2 and
     4) equal to a replay with the shard-level permutation, and the
     streams of config 1 and 1080p faster with intra_plan.MESH and of
     1080p medium with intra_presel.MESH byte-identical to the unsharded
     encodes above (and decoded); K4's gathered entry and K3's reference
     entry must launch in the hooked all-intra faster encodes, K4's
     gathered entry in the medium one.  Then
     graft_entry.dryrun_multichip(4), where search_step launches K1, K2,
     K6 and K7.
   With --old-csrc DIR (an older checkout's vvenc_tpu_torch/csrc, for
   example the parent commit's, unpacked), phase 3 also imports the
   package that holds DIR under another name (old_package), builds its
   K1-K3 and K5-K11 with its own kernels module and sets them against
   the current ones, called alike (old_new_case): K3's two entries on
   every class of the planning shapes above (modes equal, costs within
   rtol 1e-5, device time warm and cold; the run fails where a class of
   the reference entry takes more device time than the old one by more
   than 5 %, and prints the public plan_trial_refs against the older
   wrapper on config 1's batch and picture; in phase 4 the config 1 and
   1080p all-intra faster encodes again with the older reference entry
   must give the same streams, byte for byte);
   outputs equal at every K5, K11 and K9 shape above (K9 also on its
   integer route: a 12-bit checkerboard at 16x16 R = 16 and 6x6 blocks
   at R = 8), every K6 class and search_step's shape,
   every K1 / K2 shape above, every K8 phase and K10 satd tile above (8
   and 10 bits), K10 sse and sad on the four grids above (8 and 10
   bits), K7 on every K6 class (10 bits, QP 37; timed at 16x16), times
   taken in turns (old, new, new, old; 2000 calls a turn for K1, K2 and
   K6 at search_step's shape and for K7 and K10 sse / sad, three rounds
   of turns averaged for K1 and K2, and for the public K7, K8 and K10
   calls against the older package's own wrappers), device times (one
   phase of each K8 kind, satd tile 8, every sse / sad grid and K7 at
   16x16 also after an L2 flush), the old kernels' resources.
   K6's and K9's bounds count the work as each kernel computes it
   (tr_bound_ms, fs_bound_ms), their int32 count beside as the
   yardstick.
5. Prints a {"kernels": [...]} line, then the card line, then the last
   line {"ok": true, "device": {...}}.

--json PATH also writes the detailed numbers (per class and bit depth)
to PATH.
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM rate
# and the non-tensor-core 32-bit rate, the nearest entry for the int32
# arithmetic of these kernels
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12     # dense int8 tensor-core peak
FP32_FLOPS_PER_S = 67e12        # float32 CUDA cores, a fused multiply-add 2
COST_RTOL = 1e-5
# search_step's batch on one position of graft_entry.dryrun_multichip(4)'s
# 2x2 mesh: 2 * 2 gops x 2 tiles x 2 blocks of 16x16 over 4 positions
SEARCH_STEP_BLOCKS = 4
# K11's sizes in phase 3: (tag, block side); the 1080p tags on a 1080p
# picture, the others on a 416x240 one
MODE_SIZES = (("1080p 16x16", 16), ("1080p 32x32", 32), ("416x240 4x4", 4),
              ("416x240 8x8", 8), ("416x240 64x64", 64))

# kernel entry -> (source, the TPU program it replaces)
KERNELS = {
    "intra_pred_all": ("vvenc_tpu_torch/csrc/intra_pred_all.cu",
                       "vvenc_tpu/ops/intra_presel.py:63"),
    "satd_modes": ("vvenc_tpu_torch/csrc/satd_modes.cu",
                   "vvenc_tpu/ops/intra_presel.py:176"),
    "plan_trial": ("vvenc_tpu_torch/csrc/plan_trial.cu",
                   "vvenc_tpu/ops/intra_plan.py:109"),
    "plan_trial_refs": ("vvenc_tpu_torch/csrc/plan_trial.cu",
                        "vvenc_tpu/ops/intra_plan.py:109"),
    "presel_costs": ("vvenc_tpu_torch/csrc/presel_costs.cu",
                     "vvenc_tpu/ops/intra_presel.py:197"),
    "frame_me": ("vvenc_tpu_torch/csrc/frame_me.cu",
                 "vvenc_tpu/ops/me.py:92"),
    "presel_costs_gathered": ("vvenc_tpu_torch/csrc/presel_costs.cu",
                              "vvenc_tpu/ops/intra_presel.py:197"),
    "fwd_transform_batch": ("vvenc_tpu_torch/csrc/transform_batch.cu",
                            "vvenc_tpu/ops/transforms.py:496"),
    "inv_transform_batch": ("vvenc_tpu_torch/csrc/transform_batch.cu",
                            "vvenc_tpu/ops/transforms.py:524"),
    "quant_batch": ("vvenc_tpu_torch/csrc/quant_batch.cu",
                    "vvenc_tpu/ops/transforms.py:542"),
    "dequant_batch": ("vvenc_tpu_torch/csrc/quant_batch.cu",
                      "vvenc_tpu/ops/transforms.py:565"),
    "mc_batch": ("vvenc_tpu_torch/csrc/mc_batch.cu",
                 "vvenc_tpu/ops/interp.py:183"),
    "full_search_sse": ("vvenc_tpu_torch/csrc/full_search.cu",
                        "vvenc_tpu/ops/me.py:38"),
    "sse_batch": ("vvenc_tpu_torch/csrc/dist_batch.cu",
                  "vvenc_tpu/ops/rdcost.py:67"),
    "sad_batch": ("vvenc_tpu_torch/csrc/dist_batch.cu",
                  "vvenc_tpu/ops/rdcost.py:73"),
    "satd_batch": ("vvenc_tpu_torch/csrc/dist_batch.cu",
                   "vvenc_tpu/ops/rdcost.py:78"),
    "mode_costs": ("vvenc_tpu_torch/csrc/mode_costs.cu",
                   "vvenc_tpu/ops/intra_batch.py:100"),
}
# device planning's two launches per class: the fused 67-mode SATD (K4's
# gathered entry) and K3's reference entry
PLAN_KERNELS = ("presel_costs_gathered", "plan_trial_refs")
# K1 -> K2 -> K3 on K1's predictions, device planning's route before the
# fused one: held per class beside it; no encode path may launch them
# (K1 and K2 stay on the mesh path's search_step)
OLD_PLAN_KERNELS = ("intra_pred_all", "satd_modes", "plan_trial")
CLASS_KERNELS = OLD_PLAN_KERNELS + PLAN_KERNELS
# the planning entries run_classes also times on the device, warm and
# cold, per class: K4's gathered entry and K3's two entries
DEVICE_CLASS_KERNELS = ("presel_costs_gathered", "plan_trial",
                        "plan_trial_refs")
# a redesigned K3 class fails the old/new comparison when its device time
# exceeds the parent's by more than this share (the profiler's spread
# between sessions of one call)
K3_NOISE = 0.05
TR_KERNELS = ("fwd_transform_batch", "inv_transform_batch", "quant_batch",
              "dequant_batch")
K6_ENTRIES = TR_KERNELS[:2]
# the dry run: search_step (K1, K2, K6, K7), the sharded presel (K4's
# gathered entry) and the e2e encode with intra_plan.MESH (PLAN_KERNELS)
MESH_KERNELS = ("intra_pred_all", "satd_modes") + PLAN_KERNELS + TR_KERNELS
# K6/K7's classes: every square class and two rectangular ones
TR_CLASSES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (16, 8))
# K8-K11: the public functions that only their own callers reach
BATCH_KERNELS = ("mc_batch", "full_search_sse", "sse_batch", "sad_batch",
                 "satd_batch", "mode_costs")
# K9's timed shapes on 1080p grids: (block side, R)
FS_SHAPES = ((16, 16), (8, 8), (64, 16))
# K8's phases: the 16 quarter-pel luma phases, a few 1/32 chroma ones
LUMA_PHASES = tuple((fx, fy) for fy in (0, 4, 8, 12) for fx in (0, 4, 8, 12))
CHROMA_PHASES = ((0, 0), (16, 0), (0, 8), (5, 27), (31, 31))
# K8's kinds (0 copy, 1 horizontal, 2 vertical, 3 both) at one phase each,
# luma 16x16 and chroma 8x8
K8_KINDS = {"luma": ((0, 0), (8, 0), (0, 8), (8, 8)),
            "chroma": ((0, 0), (16, 0), (0, 8), (5, 27))}
# K10 satd's tiles on the 1080p 16x16 and 64x64 grids
SATD_TILES = {"16x16": (4, 8, 16), "64x64": (4, 8, 64)}
# K10 sse's and sad's 1080p luma grids (block sides; B = 129,600, 32,400,
# 8,040 and 480)
DIST_GRIDS = (4, 8, 16, 64)


def luma_frames(w: int, h: int, n: int, bit_depth: int, seed: int):
    """n smooth luma frames at bit_depth (shifted windows of one field)."""
    import scipy.ndimage as ndi
    rng = np.random.RandomState(seed)
    base = ndi.gaussian_filter(
        rng.randint(0, 255, (h + 4 * n, w + 4 * n)).astype(np.float32), 3)
    top = (1 << bit_depth) - 1
    base = (base - base.min()) / (base.max() - base.min()) * 0.8 * top \
        + 0.1 * top
    return [np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]
                                 .astype(np.int32)) for i in range(n)]


def nonzero(launches: dict) -> dict:
    """The entries of a launch count that launched."""
    return {k: v for k, v in launches.items() if v}


def no_old_route(tag: str, launches: dict) -> None:
    """Fails if an encode path launched K1, K2 or the preds-form K3:
    device planning takes the fused route on every path."""
    bad = {n: launches[n] for n in OLD_PLAN_KERNELS if launches[n]}
    if bad:
        fail(f"{tag}: {bad} launched on an encode path: {launches}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def stamp(t0: float, label: str) -> None:
    """Prints how far into the run (seconds since t0) `label` ended."""
    print(f"  ({label} done {time.time() - t0:.1f} s into the run)",
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after a
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def work(name: str, B: int, s: int, k: int) -> tuple:
    """(bytes, int32 operations) the function needs for B blocks of s x s
    (each input read once, each output written once)."""
    M, n = 67, s * s
    if name == "presel_costs_gathered":
        return gathered_work(B, s, s)
    if name == "plan_trial_refs":
        # plan_trial with the references read in place of the k
        # predictions, which it computes: K1's 11 operations a sample
        nb, ops = work("plan_trial", B, s, k)
        return (nb - B * k * n * 2 + B * 2 * (2 * s + 3) * 4,
                ops + B * k * n * 11)
    if name in ("intra_pred_all", "satd_modes"):
        return k12_work(name, B, s, s)
    # plan_trial: reads satd, lambdas, the source and the k survivors'
    # predictions, writes modes + costs; four s^3 products per survivor
    return (B * (M * 4 + 8 + n * 4 + k * n * 2 + k * 8),
            B * k * (4 * s * n * 2 + 20 * n))


def k12_work(name: str, B: int, w: int, h: int) -> tuple:
    """(bytes, int32 operations) of K1 or K2 on B blocks of w x h.  K1
    reads tops + lefts (LPAD = 2 max(w, h) + 3 each) and writes the 67
    predictions: 4 multiply-adds, a round, a shift and a clip a sample.
    K2 reads the source and the 67 predictions and writes [B, 67]: per
    8x8 tile 2*3*64 butterfly adds, a subtraction, an abs and a sum a
    sample."""
    M, n = 67, w * h
    if name == "intra_pred_all":
        return B * (2 * (2 * max(w, h) + 3) * 4 + M * n * 2), B * M * n * 11
    return B * (n * 4 + M * n * 2 + M * 4), B * M * n * 9


def plan_bound_ms(B: int, s: int, k: int,
                  name: str = "plan_trial") -> tuple:
    """(least milliseconds, "bytes" or "operations") of K3 (`name`: the
    preds form or the reference entry) on one s x s class as the kernel
    computes it.  From 16x16 up the four s^3 products of a survivor run
    on the int8 tensor cores, each as two int8 products (the split data
    operand), 2 operations a multiply-add at the 1,979 T/s int8 peak,
    beside the 20 per-sample operations (31 with the reference entry's
    prediction) at the int32 rate; 4x4 and 8x8 run on the CUDA cores and
    count work()'s int32 operations.  work()'s int32 count on every class
    stays the fixed yardstick beside it."""
    nbytes, ops = work(name, B, s, k)
    if s < 16:
        return bound_ms(nbytes, ops)
    per_sample = 20 + (11 if name == "plan_trial_refs" else 0)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(B * k * 4 * s ** 3 * 2 * 2 / INT8_TC_OPS_PER_S,
             B * k * per_sample * s * s / INT32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def presel_work(B: int, w: int, h: int, plane_bytes: int) -> tuple:
    """(bytes, int32 operations) of K4 on one class: reads the plane and
    the grid, writes [B, 67] int32; per prediction sample K1's 11 and
    K2's 9 operations (no intermediate is written).  Counted against the
    67 T/s float32 peak, the fixed yardstick of every K4 design; Hopper
    issues 32-bit integer multiply-adds at half that rate (64 lanes per
    SM per clock), so a kernel on integer CUDA cores can approach this
    bound but not reach it; K4 runs its per-sample arithmetic on the
    float32 pipe."""
    return plane_bytes + B * 67 * 4, B * 67 * w * h * (11 + 9)


def gathered_work(B: int, w: int, h: int) -> tuple:
    """(bytes, int32 operations) of K4's gathered entry on one class:
    reads the blocks and both references (int32), writes [B, 67] int32;
    the operations of the plane form."""
    return (B * (w * h + 2 * w + 3 + 2 * h + 3 + 67) * 4,
            B * 67 * w * h * (11 + 9))


def tr_work(name: str, B: int, w: int, h: int) -> tuple:
    """(bytes, int32 operations) of one K6 or K7 entry on B blocks of
    w x h: the int32 input read once and the output written once; a
    DCT-2 stage costs 2 operations per multiply-add and 4 per output (a
    round, a shift, two clip compares), the forward pass's second stage
    only for the 32x32 samples it keeps; quant 6 operations per sample
    (abs, multiply, add, shift, sign, multiply), dequant 8 (two clip
    compares, multiply, add, shift, two clip compares, a branch)."""
    n = B * w * h
    if name == "fwd_transform_batch":
        kept = B * min(w, 32) * min(h, 32)
        return 8 * n, n * (2 * w + 4) + kept * (2 * h + 4)
    if name == "inv_transform_batch":
        return 8 * n, n * (2 * h + 4) + n * (2 * w + 4)
    return 8 * n, (6 if name == "quant_batch" else 8) * n


def tr_bound_ms(name: str, B: int, w: int, h: int) -> tuple:
    """(least milliseconds, "bytes" or "operations") of one K6 entry on
    B blocks of w x h as the kernel computes it: a stage that contracts
    16 points or more runs on the int8 tensor cores, each multiply-add as
    two int8 products (the split data operand), 2 operations each at the
    1,979 T/s int8 peak; a 4- or 8-point stage costs 2 int32 operations a
    multiply-add, and every output of a stage 4 (a round, a shift, two
    clip compares), at the int32 rate.  Only the outputs the function
    keeps are counted: the forward 64-point zero-out needs 32 of a 64-point
    stage's outputs.  tr_work's int32 count stays the yardstick beside."""
    nbytes = tr_work(name, B, w, h)[0]
    if name == "fwd_transform_batch":
        # stage 1 along w (h * min(w, 32) outputs a block), stage 2 along
        # h on the kept min(w, 32) x min(h, 32)
        stages = ((w, B * h * min(w, 32)), (h, B * min(w, 32) * min(h, 32)))
    else:
        # stage 1 along h, stage 2 along w, every output
        stages = ((h, B * w * h), (w, B * w * h))
    tc = sum(k * n * 2 * 2 for k, n in stages if k >= 16)
    ops = sum(n * (4 + (2 * k if k < 16 else 0)) for k, n in stages)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(tc / INT8_TC_OPS_PER_S, ops / INT32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tr_bound(n: str, r: dict) -> tuple:
    """(least ms, "bytes" or "operations") of TR_KERNELS entry n on
    run_tr's record r: K6 as it computes (tr_bound_ms), K7 its int32
    count."""
    if n in K6_ENTRIES:
        return tr_bound_ms(n, r["B"], r["w"], r["h"])
    return bound_ms(*r["work"][n])


def me_work(W: int, H: int, R: int) -> tuple:
    """(bytes, int32 operations) of K5 on one picture pair: reads both
    padded int16 planes, writes mv [N, 2] int32 + cost [N] f32; pools
    each plane once (one add per sample), then per block 3 operations
    (subtract, multiply, add) per pooled difference of the (2R/4+1)^2
    stage-1 candidates and per sample of the 49 stage-2 candidates, and
    a compare per candidate."""
    N = (W // 16) * (H // 16)
    D = (2 * (R // 4) + 1) ** 2
    plane = (H + 192) * (W + 192)
    return (2 * plane * 2 + N * 12,
            2 * plane + N * (D * 16 * 3 + 49 * 256 * 3 + D + 49))


def mc_work(B: int, w: int, h: int, ntaps: int, fx: int, fy: int) -> tuple:
    """(bytes, int32 operations) of one K8 call: the int32 window samples
    the phase's kind needs read once (the copy h x w, horizontal only h x
    (w + n - 1), vertical only (h + n - 1) x w, both the whole window),
    the output written once; a filter output costs 2 per tap (multiply,
    add) and 2 more (offset, shift), the last stage 2 more (clip); the
    two-stage case filters every window row first."""
    e = ntaps - 1
    reads = (h + (e if fy else 0)) * (w + (e if fx else 0))
    nbytes = B * (reads + h * w) * 4
    if fx == 0 and fy == 0:
        return nbytes, 0
    last = h * w * (2 * ntaps + 4)
    first = (h + ntaps - 1) * w * (2 * ntaps + 2) if fx and fy else 0
    return nbytes, B * (first + last)


def fs_work(B: int, h: int, w: int, R: int) -> tuple:
    """(bytes, int32 operations) of K9: blocks and areas read once, the
    float32 costs written once; per displacement and sample a subtract,
    a multiply and an add."""
    g = 2 * R + 1
    return (B * (h * w + (h + 2 * R) * (w + 2 * R) + g * g) * 4,
            B * g * g * h * w * 3)


def fs_bound_ms(B: int, h: int, w: int, R: int,
                float_route: bool = True) -> tuple:
    """(least milliseconds, "bytes" or "operations") of K9 as the kernel
    computes it.  On the float32 route (samples within [0, 1023], w a
    multiple of 4, at most 4096 samples a block) SSE = sum(a^2) - 2 corr +
    sum(b^2): the correlation one fused multiply-add per displacement and
    sample, the a^2 windows a square per area sample and a slide (one out,
    one in) per window row and per window, sum(b^2) a multiply-add per
    block sample and 3 operations a displacement to combine them, at the
    float32 peak.  On the integer route fs_work's int32 count, which stays
    the yardstick beside both."""
    nbytes, ops32 = fs_work(B, h, w, R)
    if not float_route:
        return bound_ms(nbytes, ops32)
    g, ah, aw = 2 * R + 1, h + 2 * R, w + 2 * R
    flops = B * (g * g * h * w * 2 + ah * aw * 2 + ah * g * 4
                 + g * g * 4 + h * w * 2 + g * g * 3)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / FP32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def dist_work(name: str, B: int, H: int, W: int, tile: int = 8) -> tuple:
    """(bytes, int32 operations) of one K10 entry: both inputs read once,
    [B] written; per sample a subtract and an add plus a multiply (sse)
    or an abs (sad), or for satd the tile's 2 log2(tile) butterfly adds
    and an abs."""
    n = B * H * W
    ops = 3 * n if name != "satd_batch" else \
        n * (3 + 2 * (tile.bit_length() - 1))
    return n * 8 + B * 4, ops


def dist_pair(x: dict, s: int) -> tuple:
    """The two [B, s, s] inputs of K10 on the 1080p s x s grid among
    run_batch_ops' inputs x."""
    if s == 16:
        return x["blocks"], x["b16"]
    return x[f"a{s}"], x[f"b{s}"]


def mode_work(B: int, s: int) -> tuple:
    """(bytes, int32 operations) of K11 on B blocks of s x s: rm, the
    source blocks and both references read once, [B, 67] written; per
    prediction sample K1's 11 operations and K2's 9 (no intermediate is
    written)."""
    L = 3 * s + 8
    return (B * (67 * L + s * s + 2 * (2 * s + 3) + 67) * 4,
            B * 67 * s * s * (11 + 9))


def batch_bound(n: str, batch: dict) -> tuple:
    """(least ms, "bytes" or "operations") of BATCH_KERNELS entry n on
    run_batch_ops' record: K9 as it computes (fs_bound_ms, 16x16 at
    R = 16), the others their int32 count."""
    if n == "full_search_sse":
        return fs_bound_ms(batch["B"], 16, 16, 16)
    return bound_ms(*batch["work"][n])


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(least milliseconds, "bytes" or "operations") for the given work."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def run_classes(torch, dev, srcs, bit_depth, qp, lmbda, sizes,
                implicit_mts, k, reps, plain_reps, check):
    """Every class of one frame batch through device planning's route
    (the fused SATD, K4's gathered entry, then K3's reference entry),
    through K1 -> K2 -> K3 and through the plain versions: the fused SATD
    bit-exact to K2(K1(...)) and to the plain one, both K3 entries' modes
    equal to plan_trial_ref's and their costs within COST_RTOL.  Times
    each kernel per class (its plain version too when plain_reps > 0).
    Returns per-class records and the flat (class, frame, block)
    modes/costs of the route, of K1 -> K2 -> K3 and of the plain
    versions."""
    from vvenc_tpu_torch.ops import intra_plan as P
    from vvenc_tpu_torch.ops import intra_presel as S
    recs, out = [], {"route": [], "old": [], "plain": []}
    for s in sizes:
        blocks, tops, lefts, lm, ls = class_batch(torch, dev, srcs, s, lmbda)
        B = blocks.shape[0]
        fk = S.presel_costs(blocks, tops, lefts, s, s, bit_depth)
        fmk, fck = P.plan_trial_refs(blocks, tops, lefts, fk, lm, ls, s, s,
                                     qp, bit_depth, implicit_mts, k)
        pk = S.predict_all_modes(tops, lefts, s, s, bit_depth)
        pr = S.predict_all_modes_ref(tops, lefts, s, s, bit_depth)
        sk = S.satd_batch(blocks, pk, s, s)
        sr = S.satd_batch_ref(blocks, pr, s, s)
        mk, ck = P.plan_trial(blocks, pk, sk, lm, ls, s, s, qp, bit_depth,
                              implicit_mts, k)
        mr, cr = P.plan_trial_ref(blocks, pr, sr, lm, ls, s, s, qp,
                                  bit_depth, implicit_mts, k)
        torch.cuda.synchronize()
        rec = {"s": s, "B": B, "bit_depth": bit_depth}
        if check:
            if not torch.equal(pk, pr):
                bad = (pk != pr).nonzero()[:5].tolist()
                fail(f"K1 intra_pred_all != plain at {s}x{s}, "
                     f"{bit_depth}-bit; first [b, mode, y, x]: {bad}")
            if not torch.equal(sk, sr):
                fail(f"K2 satd_modes != plain at {s}x{s}, {bit_depth}-bit")
            if not torch.equal(fk, sk):
                fail(f"the fused SATD (presel_costs) != K2(K1(...)) at "
                     f"{s}x{s}, {bit_depth}-bit")
            for name, m_, c_ in (("plan_trial", mk, ck),
                                 ("plan_trial_refs", fmk, fck)):
                if not torch.equal(m_, mr):
                    fail(f"K3 {name} modes != plain at {s}x{s}, "
                         f"{bit_depth}-bit")
                rel = ((c_ - cr).abs() / cr.abs().clamp_min(1e-30)).max() \
                    .item()
                if not rel <= COST_RTOL:
                    fail(f"K3 {name} costs: rel err {rel} > {COST_RTOL} at "
                         f"{s}x{s}, {bit_depth}-bit")
                rec[f"{name}_max_rel_err"] = rel
                rec[f"{name}_max_abs_err"] = (c_ - cr).abs().max().item()
        args3 = (blocks, pk, sk, lm, ls, s, s, qp, bit_depth, implicit_mts,
                 k)
        args3r = (blocks, tops, lefts, fk, lm, ls, s, s, qp, bit_depth,
                  implicit_mts, k)
        calls = {
            "intra_pred_all": (
                lambda: S.predict_all_modes(tops, lefts, s, s, bit_depth),
                lambda: S.predict_all_modes_ref(tops, lefts, s, s,
                                                bit_depth)),
            "satd_modes": (lambda: S.satd_batch(blocks, pk, s, s),
                           lambda: S.satd_batch_ref(blocks, pk, s, s)),
            "plan_trial": (lambda: P.plan_trial(*args3),
                           lambda: P.plan_trial_ref(*args3)),
            "presel_costs_gathered": (
                lambda: S.presel_costs(blocks, tops, lefts, s, s,
                                       bit_depth),
                lambda: S.presel_costs_ref(blocks, tops, lefts, s, s,
                                           bit_depth)),
            "plan_trial_refs": (lambda: P.plan_trial_refs(*args3r),
                                lambda: P.plan_trial_refs_ref(*args3r)),
        }
        rec["ms"] = {n: cuda_ms(torch, c[0], reps) for n, c in calls.items()}
        # the device time of one call, warm and after an L2 flush
        dreps = 20
        rec["device_ms"] = {n: call_device_ms(torch, calls[n][0], dreps)
                            for n in DEVICE_CLASS_KERNELS}
        rec["cold_device_ms"] = {
            n: call_device_ms(torch, calls[n][0], dreps, cold=True)
            for n in DEVICE_CLASS_KERNELS}
        rec["plain_ms"] = {n: cuda_ms(torch, c[1], plain_reps)
                           if plain_reps else None
                           for n, c in calls.items()}
        rec["work"] = {n: work(n, B, s, k) for n in CLASS_KERNELS}
        rec["bound_ms"] = {n: bound_ms(*rec["work"][n])[0]
                           for n in CLASS_KERNELS}
        rec["k3_int32_bound_ms"] = rec["bound_ms"]["plan_trial"]
        rec["bound_by"] = {n: bound_ms(*rec["work"][n])[1]
                           for n in CLASS_KERNELS}
        for n in ("plan_trial", "plan_trial_refs"):
            rec["bound_ms"][n], rec["bound_by"][n] = plan_bound_ms(B, s, k,
                                                                   n)
        recs.append(rec)
        for key, (m_, c_) in (("route", (fmk, fck)), ("old", (mk, ck)),
                              ("plain", (mr, cr))):
            out[key].append((m_.cpu().numpy(), c_.cpu().numpy()))
        del pk, pr, sk, sr
    cat = np.concatenate
    return recs, {key: (cat([a for a, _ in v]), cat([b for _, b in v]))
                  for key, v in out.items()}


def class_sums(recs, what: str = "ms") -> dict:
    """The per-kernel sum over a run's classes of rec[what]."""
    return {n: sum(r[what][n] for r in recs) if all(
        r[what][n] is not None for r in recs) else None
        for n in CLASS_KERNELS}


def print_classes(recs) -> None:
    def f(v):
        return "not timed" if v is None else f"{v:.4f}"

    def dev(r, n):
        if n not in DEVICE_CLASS_KERNELS:
            return ""
        return (f"device {dev_str(r['device_ms'][n])}, cold "
                f"{dev_str(r['cold_device_ms'][n])}, ")
    for r in recs:
        print(f"  class {r['s']:2d} B={r['B']:6d}: " + ", ".join(
            f"{n} {r['ms'][n]:.4f} ms ({dev(r, n)}plain "
            f"{f(r['plain_ms'][n])}, bound {r['bound_ms'][n]:.4f} "
            f"{r['bound_by'][n]})" for n in CLASS_KERNELS), flush=True)
    for n in DEVICE_CLASS_KERNELS:
        print(f"  {n} class sums: call {sum(r['ms'][n] for r in recs):.4f} "
              f"ms, device "
              f"{dev_str(dev_sum(r['device_ms'][n] for r in recs))}, cold "
              f"{dev_str(dev_sum(r['cold_device_ms'][n] for r in recs))}, "
              f"bound {sum(r['bound_ms'][n] for r in recs):.4f}",
              flush=True)


def build_plans_phase(torch, dev, report):
    """build_plans on config 1's batch (10 frames of 416x240) and on
    1080p faster's (4 frames), through device planning's route and
    through K1 -> K2 -> K3 (the route before it, put back in
    _plan_class_core for the comparison), in turns (route, old, old,
    route): host milliseconds to the fetched tables, the peak of
    torch.cuda.max_memory_allocated above the allocation before the call,
    and the plan tables of the two equal."""
    from vvenc_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                       lambda_for_qp)
    from vvenc_tpu_torch.ops import intra_plan as P
    from vvenc_tpu_torch.ops import intra_presel as S

    def old_core(src, tops, lefts, lm, ls, w, h, qp, bd, mts, k):
        preds = S.predict_all_modes(tops, lefts, w, h, bd)
        satd = S.satd_batch(src, preds, w, h)
        return P.plan_trial(src, preds, satd, lm, ls, w, h, qp, bd, mts, k)

    slice_qp = 37 + EncoderConfig.intra_qp_offset
    out = {}
    for tag, W, H, F in (("config1", 416, 240, 10),
                         ("hd_faster", 1920, 1080, 4)):
        srcs = luma_frames(W, H, F, 10, seed=5)
        lm = float(np.float32(lambda_for_qp(slice_qp, 10)))
        ls = float(np.float32(lm) ** 0.5)
        core = P._plan_class_core
        rec = {"route": {"ms": [], "peak_bytes": []},
               "k1_k2_k3": {"ms": [], "peak_bytes": []}}
        tables = {}
        for route in ("route", "k1_k2_k3", "k1_k2_k3", "route"):
            P._plan_class_core = core if route == "route" else old_core
            try:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                plans = P.build_plans(srcs, 10, 64, EncoderConfig.min_qt,
                                      slice_qp + 12, [lm] * F, [ls] * F,
                                      device=dev)
                ms = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated() - base
            finally:
                P._plan_class_core = core
            rec[route]["ms"].append(ms)
            rec[route]["peak_bytes"].append(peak)
            tables[route] = plans
        for f in range(F):
            a, b = tables["route"][f].tables, tables["k1_k2_k3"][f].tables
            if set(a) != set(b) or any(
                    not np.array_equal(x, y) for key in a
                    for x, y in zip(a[key], b[key])):
                fail(f"build_plans {tag}: the route's plan tables differ "
                     f"from K1 -> K2 -> K3's at frame {f}")
        out[tag] = rec
        print(f"phase 3: build_plans {tag} ({F} x {W}x{H}, 10-bit): plan "
              f"tables of the route equal to K1 -> K2 -> K3's; route "
              f"{min(rec['route']['ms']):.3f} ms, peak "
              f"{max(rec['route']['peak_bytes']) / 1e6:.1f} MB above the "
              f"call; K1 -> K2 -> K3 {min(rec['k1_k2_k3']['ms']):.3f} ms, "
              f"peak {max(rec['k1_k2_k3']['peak_bytes']) / 1e6:.1f} MB "
              f"(min time and max peak of 2, in turns)", flush=True)
    report["build_plans"] = out


def run_presel(torch, dev, pic, bd, reps, plain_reps):
    """K4 on every MTT class of one picture against its plain version
    (bit-exact), timed per class; then the whole picture as FramePresel
    runs it (every class into one buffer) and its one fetch, timed
    apart.  Returns (per-class records, picture record)."""
    from vvenc_tpu_torch.ops import intra_presel as S
    H, W = pic.shape
    pad = S.FramePresel.PAD
    plane = torch.from_numpy(np.pad(pic, pad, mode="edge")
                             .astype(np.int16)).to(dev)
    plane_bytes = plane.numel() * 2
    shapes, mtt = S.shapes_for_config(128, 2)
    recs, grids = [], []
    for (w, h) in shapes:
        xs, ys, _, _ = S._class_grid(W, H, w, h, mtt)
        xs_d = torch.from_numpy(xs).to(dev)
        ys_d = torch.from_numpy(ys).to(dev)
        grids.append((w, h, xs_d, ys_d))
        B = len(xs) * len(ys)
        ck = S.presel_costs_plane(plane, pad, xs_d, ys_d, w, h, bd)
        inputs = S.plane_inputs(plane, pad, xs_d, ys_d, w, h)
        cr = S.presel_costs_ref(*inputs, w, h, bd)
        cg = S.presel_costs(*inputs, w, h, bd)
        torch.cuda.synchronize()
        if not torch.equal(ck, cr):
            bad = (ck != cr).nonzero()[:5].tolist()
            fail(f"K4 presel_costs != plain at {w}x{h}, {bd}-bit "
                 f"({W}x{H}); first [b, mode]: {bad}")
        if not torch.equal(cg, cr):
            bad = (cg != cr).nonzero()[:5].tolist()
            fail(f"K4 presel_costs (gathered) != plain at {w}x{h}, "
                 f"{bd}-bit ({W}x{H}); first [b, mode]: {bad}")
        rec = {"w": w, "h": h, "B": B, "bit_depth": bd,
               "work": presel_work(B, w, h, plane_bytes),
               "gathered_work": gathered_work(B, w, h)}
        if reps:
            rec["ms"] = cuda_ms(torch, lambda: S.presel_costs_plane(
                plane, pad, xs_d, ys_d, w, h, bd), reps)
            rec["gathered_ms"] = cuda_ms(torch, lambda: S.presel_costs(
                *inputs, w, h, bd), reps)
            rec["plain_ms"] = cuda_ms(torch, lambda: S.presel_costs_ref(
                *inputs, w, h, bd), plain_reps)
        recs.append(rec)
        del ck, cr, cg, inputs
    pic_rec = None
    if reps:
        total = sum(r["B"] for r in recs)
        out = torch.empty((total, 67), dtype=torch.int32, device=dev)

        def picture():
            off = 0
            for (w, h, xs_d, ys_d), r in zip(grids, recs):
                S.presel_costs_plane(plane, pad, xs_d, ys_d, w, h, bd,
                                     out=out[off:off + r["B"]])
                off += r["B"]
        launch_ms = cuda_ms(torch, picture, reps)
        # the picture's launches on the device, warm and after an L2 flush
        device_ms = call_device_ms(torch, picture, 20)
        cold_device_ms = call_device_ms(torch, picture, 20, cold=True)
        pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        fetch, pageable, whole = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            pinned.copy_(out, non_blocking=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out.cpu()
            t2 = time.perf_counter()
            fetch.append((t1 - t0) * 1e3)
            pageable.append((t2 - t1) * 1e3)
        for _ in range(reps):
            # what the encoder pays per picture: upload, launches, fetch
            t0 = time.perf_counter()
            S.FramePresel(pic, bd, (shapes, mtt), device=dev)
            whole.append((time.perf_counter() - t0) * 1e3)
        pic_rec = {"classes": len(recs), "B": total,
                   "cost_bytes": total * 67 * 4, "launch_ms": launch_ms,
                   "device_ms": device_ms, "cold_device_ms": cold_device_ms,
                   "fetch_ms": min(fetch), "fetch_pageable_ms": min(pageable),
                   "frame_presel_ms": min(whole)}
    return recs, pic_rec


def me_planes(torch, dev, srcs):
    """The edge-padded int16 planes of a picture pair on the card (K5's
    inputs) and the block-aligned size (Wc, Hc)."""
    from vvenc_tpu_torch.ops import me as M
    H, W = srcs[0].shape
    Hc = (H // M.ME_BS) * M.ME_BS
    Wc = (W // M.ME_BS) * M.ME_BS
    sp, rp = (torch.from_numpy(np.ascontiguousarray(
        np.pad(a, M.ME_PAD, mode="edge").astype(np.int16)
        [:Hc + 2 * M.ME_PAD, :Wc + 2 * M.ME_PAD])).to(dev) for a in srcs)
    return sp, rp, Wc, Hc


def run_me(torch, dev, srcs, R, reps, plain_reps):
    """K5 on one picture pair against its plain version: MVs and costs
    (the float32 of the exact integer SSE) equal; timed when reps > 0.
    Returns the record."""
    from vvenc_tpu_torch.ops import me as M
    sp, rp, Wc, Hc = me_planes(torch, dev, srcs)
    mk, ck = M.frame_me(sp, rp, Wc, Hc, R)
    mr, cr = M.frame_me_ref(sp, rp, Wc, Hc, R)
    torch.cuda.synchronize()
    if not torch.equal(mk, mr):
        n = int((mk != mr).any(dim=1).sum())
        fail(f"K5 frame_me MVs != plain in {n} of {mk.shape[0]} blocks "
             f"({Wc}x{Hc})")
    if not torch.equal(ck, cr):
        fail(f"K5 frame_me costs != plain in {int((ck != cr).sum())} of "
             f"{ck.shape[0]} blocks ({Wc}x{Hc})")
    rec = {"W": Wc, "H": Hc, "R": R, "blocks": mk.shape[0],
           "max_abs_err": (ck - cr).abs().max().item(),
           "work": me_work(Wc, Hc, R)}
    if reps:
        rec["ms"] = cuda_ms(torch, lambda: M.frame_me(sp, rp, Wc, Hc, R),
                            reps)
        rec["plain_ms"] = cuda_ms(torch, lambda: M.frame_me_ref(
            sp, rp, Wc, Hc, R), plain_reps)
    return rec


def k12_cases(torch, dev, pic) -> dict:
    """K1's and K2's inputs at their timed shapes: {tag: (w, h, blocks,
    tops, lefts)} for search_step's (the 4 16x16 blocks of one position of
    dryrun_multichip(4), graft_entry's example inputs), the QT grid of
    every class of TR_CLASSES on the 1080p 10-bit picture pic, and each
    class of config 1's plan batch (10 frames of 416x240, 10-bit)."""
    from vvenc_tpu_torch import graft_entry
    from vvenc_tpu_torch.encoder.intra_encoder import EncoderConfig
    from vvenc_tpu_torch.ops import intra_plan as P
    B, s = SEARCH_STEP_BLOCKS, 16
    out = {"search_step 16x16": (s, s) + tuple(
        torch.from_numpy(a).to(dev)
        for a in graft_entry._example_inputs(B, s, s, seed=4))}
    H, W = pic.shape
    plane = padded_plane(torch, dev, pic)
    for (w, h) in TR_CLASSES:
        out[f"1080p {w}x{h}"] = (w, h) + grid_inputs(plane, W, H, w, h)
    cw, ch = 416, 240
    planes = torch.from_numpy(np.stack(
        [np.pad(f, P.PAD, mode="edge") for f in
         luma_frames(cw, ch, 10, 10, seed=1)]).astype(np.int16)).to(dev)
    for c in P._plan_sizes(cw, ch, 64, EncoderConfig.min_qt):
        out[f"config1 batch {c}x{c}"] = (c, c) + P._class_inputs(
            planes, c, cw, ch)
    return out


def run_k12(torch, dev, cases, reps, plain_reps):
    """K1 and K2 on every case of k12_cases, bit-exact against their
    plain versions at 10 bits; each timed: the public function (CUDA
    events, "ms"; 2000 calls at search_step's shape, where
    dryrun_multichip(4) launches them), the kernel's device time of one
    call (profiler, "device_ms") and, at search_step's shape, the plain
    version.  Returns {tag: {entry: record}}."""
    from vvenc_tpu_torch.ops import intra_presel as S
    out = {}
    for tag, (w, h, blocks, tops, lefts) in cases.items():
        B = blocks.shape[0]
        preds = S.predict_all_modes(tops, lefts, w, h, 10)
        if not torch.equal(preds, S.predict_all_modes_ref(tops, lefts, w, h,
                                                          10)):
            fail(f"K1 intra_pred_all != plain at {tag}")
        if not torch.equal(S.satd_batch(blocks, preds, w, h),
                           S.satd_batch_ref(blocks, preds, w, h)):
            fail(f"K2 satd_modes != plain at {tag}")
        calls = {"intra_pred_all": (
            lambda: S.predict_all_modes(tops, lefts, w, h, 10),
            lambda: S.predict_all_modes_ref(tops, lefts, w, h, 10)),
            "satd_modes": (lambda: S.satd_batch(blocks, preds, w, h),
                           lambda: S.satd_batch_ref(blocks, preds, w, h))}
        ss = tag.startswith("search_step")
        out[tag] = {n: {
            "B": B, "w": w, "h": h, "work": k12_work(n, B, w, h),
            "ms": cuda_ms(torch, kern, 2000 if ss else reps),
            "device_ms": call_device_ms(torch, kern, 20),
            "plain_ms": cuda_ms(torch, plain, plain_reps) if ss else None}
            for n, (kern, plain) in calls.items()}
        del preds
    return out


def padded_plane(torch, dev, pic):
    """The edge-padded int16 plane of a picture, on the card."""
    from vvenc_tpu_torch.ops import intra_presel as S
    return torch.from_numpy(np.pad(pic, S.FramePresel.PAD, mode="edge")
                            .astype(np.int16)).to(dev)


def grid_inputs(plane, W, H, w, h):
    """The QT grid of (w, h) blocks of a padded plane and their
    references, LPAD = 2 max(w, h) + 3 wide (what search_step's K1
    takes): (blocks [B, h, w], tops, lefts) int32, B row-major."""
    from vvenc_tpu_torch.ops import intra_presel as S
    pad = S.FramePresel.PAD
    xs, ys, _, _ = S._class_grid(W, H, w, h, mtt=False)
    blocks = S.plane_inputs(plane, pad, xs, ys, w, h)[0]
    m = max(w, h)
    _, tops, lefts = S.plane_inputs(plane, pad, xs, ys, m, m)
    return blocks, tops, lefts


def residuals(torch, plane, W, H, w, h, bd):
    """Source minus search_step's chosen prediction (K1 -> K2 -> the
    first minimum) for the QT grid of (w, h) blocks."""
    from vvenc_tpu_torch.ops import intra_presel as S
    blocks, tops, lefts = grid_inputs(plane, W, H, w, h)
    preds = S.predict_all_modes(tops, lefts, w, h, bd)
    best = S.satd_batch(blocks, preds, w, h).argmin(dim=1)
    B = blocks.shape[0]
    pred = preds.gather(1, best.view(B, 1, 1, 1).expand(B, 1, h, w))[:, 0]
    return blocks - pred.to(torch.int32)


def run_tr(torch, dev, pics, reps, plain_reps):
    """K6 and K7 against their plain versions, bit-exact, on the
    residuals of one 1080p picture per bit depth, every class of
    TR_CLASSES, QPs 22/37/51, both slice types; each entry timed per
    class at 10 bits, QP 37, intra: CUDA events around back-to-back
    wrapper calls ("ms") and the device time of a call
    (call_device_ms: "device_ms", None where records were lost; at
    16x16 also cold, "cold_device_ms").  Returns the per-class
    records."""
    from vvenc_tpu_torch.ops import transforms as T
    recs = []
    for bd, pic in pics.items():
        H, W = pic.shape
        plane = padded_plane(torch, dev, pic)
        for (w, h) in TR_CLASSES:
            resi = residuals(torch, plane, W, H, w, h, bd)
            ck = T.fwd_transform_batch(resi, w, h, bd)
            if not torch.equal(ck, T.fwd_transform_batch_ref(resi, w, h,
                                                             bd)):
                fail(f"K6 fwd_transform_batch != plain at {w}x{h}, {bd}-bit")
            if not torch.equal(T.inv_transform_batch(ck, w, h, bd),
                               T.inv_transform_batch_ref(ck, w, h, bd)):
                fail(f"K6 inv_transform_batch != plain at {w}x{h}, {bd}-bit")
            for qp in (22, 37, 51):
                for intra in (True, False):
                    qk = T.quant_batch(ck, w, h, qp, bd, intra)
                    if not torch.equal(qk, T.quant_batch_ref(ck, w, h, qp,
                                                             bd, intra)):
                        fail(f"K7 quant_batch != plain at {w}x{h}, {bd}-bit,"
                             f" QP {qp}, intra {intra}")
                    if not torch.equal(T.dequant_batch(qk, w, h, qp, bd),
                                       T.dequant_batch_ref(qk, w, h, qp,
                                                           bd)):
                        fail(f"K7 dequant_batch != plain at {w}x{h}, "
                             f"{bd}-bit, QP {qp}")
            torch.cuda.synchronize()
            if bd != 10:
                continue
            B = resi.shape[0]
            qk = T.quant_batch(ck, w, h, 37, bd)
            args = {"fwd_transform_batch": (resi, w, h, bd),
                    "inv_transform_batch": (ck, w, h, bd),
                    "quant_batch": (ck, w, h, 37, bd),
                    "dequant_batch": (qk, w, h, 37, bd)}
            rec = {"w": w, "h": h, "B": B, "bit_depth": bd, "ms": {},
                   "plain_ms": {}, "work": {}, "device_ms": {}}
            for n in TR_KERNELS:
                kern = getattr(T, n)
                plain = getattr(T, n + "_ref")
                a = args[n]
                rec["ms"][n] = cuda_ms(torch, lambda: kern(*a), reps)
                rec["plain_ms"][n] = cuda_ms(torch, lambda: plain(*a),
                                             plain_reps)
                rec["work"][n] = tr_work(n, B, w, h)
                rec["device_ms"][n] = call_device_ms(
                    torch, lambda: kern(*a), reps)
                if (w, h) == (16, 16):
                    rec.setdefault("cold_device_ms", {})[n] = call_device_ms(
                        torch, lambda: kern(*a), reps, cold=True)
            recs.append(rec)
            if (w, h) == (16, 16):
                recs.append(tr_search_step(torch, resi, ck))
    return recs


def tr_search_step(torch, resi, ck):
    """K6 at search_step's shape (SEARCH_STEP_BLOCKS 16x16 blocks, 10
    bits: the first blocks of the 1080p grid), against the plain versions
    and timed like run_tr's classes; the record is tagged "search_step"."""
    from vvenc_tpu_torch.ops import transforms as T
    B, s, bd = SEARCH_STEP_BLOCKS, 16, 10
    args = {"fwd_transform_batch": (resi[:B].contiguous(), s, s, bd),
            "inv_transform_batch": (ck[:B].contiguous(), s, s, bd)}
    rec = {"w": s, "h": s, "B": B, "bit_depth": bd, "search_step": True,
           "ms": {}, "plain_ms": {}, "work": {}, "device_ms": {}}
    for n, a in args.items():
        kern, plain = getattr(T, n), getattr(T, n + "_ref")
        if not torch.equal(kern(*a), plain(*a)):
            fail(f"K6 {n} != plain at search_step's shape")
        rec["ms"][n] = cuda_ms(torch, lambda: kern(*a), 200)
        rec["plain_ms"][n] = cuda_ms(torch, lambda: plain(*a), 20)
        rec["work"][n] = tr_work(n, B, s, s)
        rec["device_ms"][n] = call_device_ms(torch, lambda: kern(*a), 200)
    return rec


def grid_windows(torch, dev, pic, bs, span, off_y, off_x):
    """[B, span, span] int32 windows of an edge-padded picture on the
    card, one per bs x bs grid block (B row-major), each starting at the
    block's corner plus (off_y, off_x)."""
    H, W = pic.shape
    ny, nx = H // bs, W // bs
    P = span + abs(off_y) + abs(off_x)
    plane = torch.from_numpy(np.pad(pic, P, mode="edge").astype(np.int32)
                             ).to(dev)
    v = plane[P + off_y:, P + off_x:].unfold(0, span, bs).unfold(
        1, span, bs)[:ny, :nx]
    return v.reshape(ny * nx, span, span).contiguous()


def mode_inputs(torch, dev, pic, s):
    """K11's inputs for the s x s grid of a picture: (src, rm, tops,
    lefts) on the card and the host seconds of build_ref_mains."""
    from vvenc_tpu_torch.ops import intra_batch as IB
    from vvenc_tpu_torch.ops import intra_presel as S
    H, W = pic.shape
    xs, ys, _, _ = S._class_grid(W, H, s, s, mtt=False)
    src, tops, lefts = S.plane_inputs(padded_plane(torch, dev, pic),
                                      S.FramePresel.PAD, xs, ys, s, s)
    t0 = time.perf_counter()
    rm = IB.build_ref_mains(tops.cpu().numpy(), lefts.cpu().numpy(), s, s)
    secs = time.perf_counter() - t0
    return (src, torch.from_numpy(rm).to(dev), tops, lefts), secs


def mode_grid_inputs(torch, dev, pic, small):
    """K11's inputs for MODE_SIZES: the s x s grids of the 1080p picture
    `pic` and of the 416x240 picture `small`.  Returns ({tag: (src, rm,
    tops, lefts)}, {tag: host seconds of build_ref_mains})."""
    mi, secs = {}, {}
    for tag, s in MODE_SIZES:
        mi[tag], secs[tag] = mode_inputs(
            torch, dev, pic if tag.startswith("1080p") else small, s)
    return mi, secs


def run_batch_ops(torch, dev, kernels, pics, small, mi10, ref_secs, reps,
                  plain_reps):
    """K8-K11 through their public functions at 1080p shapes.  First the
    path run of each (the launch counts set to 0 just before, read just
    after: the full-width calls at 10 bits), then every call again at 8
    and 10 bits against the plain versions (bit-exact; K9's SSEs and
    argmins equal), then the times at 10 bits.  pics: {bd: (picture,
    second picture)} 1920x1080; small: {bd: 416x240 picture}; mi10,
    ref_secs: mode_grid_inputs of the 10-bit pictures.  Returns the
    report record, K9's 10-bit inputs at FS_SHAPES ({(side, R):
    (blocks, areas)}) and the K8 / K10 inputs by bit depth ({10: ..., 8:
    ...})."""
    from vvenc_tpu_torch.ops import interp as IP
    from vvenc_tpu_torch.ops import intra_batch as IB
    from vvenc_tpu_torch.ops import me as M
    from vvenc_tpu_torch.ops import rdcost as RD
    R = 16

    def inputs(bd):
        p1, p2 = pics[bd]
        chroma = np.ascontiguousarray(p2[::2, ::2])      # a 960x540 plane
        return {
            # every 16x16 block, its 23x23 window displaced by (-2, 1)
            "luma": grid_windows(torch, dev, p2, 16, 23, -3 - 2, -3 + 1),
            "chroma": grid_windows(torch, dev, chroma, 8, 11, -1 + 1, -1),
            "blocks": grid_windows(torch, dev, p1, 16, 16, 0, 0),
            "areas": grid_windows(torch, dev, p2, 16, 16 + 2 * R, -R, -R),
            "b16": grid_windows(torch, dev, p2, 16, 16, 0, 0),
            "a4": grid_windows(torch, dev, p1, 4, 4, 0, 0),
            "b4": grid_windows(torch, dev, p2, 4, 4, 0, 0),
            "a8": grid_windows(torch, dev, p1, 8, 8, 0, 0),
            "b8": grid_windows(torch, dev, p2, 8, 8, 0, 0),
            "a64": grid_windows(torch, dev, p1, 64, 64, 0, 0),
            "b64": grid_windows(torch, dev, p2, 64, 64, 0, 0),
            # K9's shapes: every block of the s x s grid, its +-R area
            "fs": {(fs, fr): (
                grid_windows(torch, dev, p1, fs, fs, 0, 0),
                grid_windows(torch, dev, p2, fs, fs + 2 * fr, -fr, -fr))
                for fs, fr in FS_SHAPES}}

    def mc_calls(x, bd):
        return ([(f"luma {fx},{fy}", lambda fx=fx, fy=fy: IP.mc_batch(
                    x["luma"], fx, fy, 16, 16, bd, True))
                 for fx, fy in LUMA_PHASES]
                + [(f"chroma {fx},{fy}", lambda fx=fx, fy=fy: IP.mc_batch(
                    x["chroma"], fx, fy, 8, 8, bd, False))
                   for fx, fy in CHROMA_PHASES])

    def dist_calls(x):
        out = []
        for s in DIST_GRIDS:
            a, b = dist_pair(x, s)
            tag = f"{s}x{s}"
            out += [(f"sse {tag}", lambda a=a, b=b: RD.sse_batch(a, b)),
                    (f"sad {tag}", lambda a=a, b=b: RD.sad_batch(a, b))]
            out += [(f"satd {tag} tile {t}", lambda a=a, b=b, t=t:
                     RD.satd_batch(a, b, t)) for t in SATD_TILES.get(tag, ())]
        return out

    x10 = inputs(10)
    torch.cuda.synchronize()
    # the path runs: the full-width calls of each public function
    paths = {}
    for name, need, run in (
            ("mc_batch", ("mc_batch",),
             lambda: [c() for _, c in mc_calls(x10, 10)]),
            ("full_search_sse", ("full_search_sse",), lambda: M.best_mv_batch(
                x10["blocks"], x10["areas"], 16, 16)),
            ("dist_batch", ("sse_batch", "sad_batch", "satd_batch"),
             lambda: [c() for _, c in dist_calls(x10)]),
            ("mode_costs", ("mode_costs",), lambda: [IB.mode_costs_batch(
                *mi10[t], int(t.split("x")[-1]), int(t.split("x")[-1]), 10)
                for t in mi10])):
        kernels.reset_launches()
        run()
        torch.cuda.synchronize()
        paths[name] = dict(kernels.launches)
        missing = [n for n in need if paths[name][n] < 1]
        if missing:
            fail(f"{name} path run: {missing} never launched: "
                 f"{paths[name]}")
    # the checks against the plain versions, 8 and 10 bits
    for bd in (10, 8):
        x = x10 if bd == 10 else inputs(8)
        for tag, call in mc_calls(x, bd):
            luma = tag.startswith("luma")
            fx, fy = (int(v) for v in tag.split()[1].split(","))
            w = 16 if luma else 8
            got = call()
            want = IP.mc_batch_ref(x["luma" if luma else "chroma"], fx, fy,
                                   w, w, bd, luma)
            if not torch.equal(got, want):
                fail(f"K8 mc_batch != plain, {tag}, {bd}-bit")
        for (fs, fr), (blk, area) in x["fs"].items():
            costs = M.full_search_sse_batch(blk, area, fs, fs)
            ref = M.full_search_sse_batch_ref(blk, area, fs, fs)
            if not torch.equal(costs, ref):
                fail(f"K9 full_search_sse != plain at {fs}x{fs}, R={fr}, "
                     f"{bd} bits: {int((costs != ref).sum())} costs differ")
            if not torch.equal(costs.flatten(1).argmin(dim=1),
                               ref.flatten(1).argmin(dim=1)):
                fail(f"K9 argmins != plain at {fs}x{fs}, R={fr}, {bd} bits")
            del costs, ref
        for tag, call in dist_calls(x):
            a, b = dist_pair(x, int(tag.split()[1].split("x")[0]))
            kind = tag.split()[0]
            want = {"sse": lambda: RD.sse_batch_ref(a, b),
                    "sad": lambda: RD.sad_batch_ref(a, b),
                    "satd": lambda: RD.satd_batch_ref(
                        a, b, int(tag.split()[-1]))}[kind]()
            if not torch.equal(call(), want):
                fail(f"K10 {tag} != plain at {bd} bits")
        mi = mi10 if bd == 10 else {
            f"416x240 {s}x{s}": mode_inputs(torch, dev, small[8], s)[0]
            for s in (4, 8, 16, 32, 64)}
        for tag, args in mi.items():
            s = int(tag.split("x")[-1])
            if not torch.equal(IB.mode_costs_batch(*args, s, s, bd),
                               IB.mode_costs_batch_ref(*args, s, s, bd)):
                fail(f"K11 mode_costs != plain, {tag}, {bd}-bit")
        torch.cuda.synchronize()
        if bd == 8:   # kept for --old-csrc's K8 / K10 comparison
            x8 = {k: v for k, v in x.items() if k not in ("fs", "areas")}
        del x
    # times at 10 bits: the kernels', the profiler's and the plain ones
    B16 = x10["blocks"].shape[0]
    rec = {"launches": paths, "build_ref_mains_s": ref_secs, "ms": {},
           "plain_ms": {}, "work": {}, "device_ms": {}, "per_call": {}}
    mc = [(fx, fy, cuda_ms(torch, lambda fx=fx, fy=fy: IP.mc_batch(
        x10["luma"], fx, fy, 16, 16, 10, True), reps),
        cuda_ms(torch, lambda fx=fx, fy=fy: IP.mc_batch_ref(
            x10["luma"], fx, fy, 16, 16, 10, True), plain_reps))
        for fx, fy in LUMA_PHASES]
    rec["per_call"]["mc_batch"] = mc
    rec["ms"]["mc_batch"] = sum(m[2] for m in mc) / len(mc)
    rec["plain_ms"]["mc_batch"] = sum(m[3] for m in mc) / len(mc)
    wk = [mc_work(B16, 16, 16, 8, fx, fy) for fx, fy in LUMA_PHASES]
    rec["work"]["mc_batch"] = (sum(w[0] for w in wk) / len(wk),
                               sum(w[1] for w in wk) / len(wk))
    timed = {
        "full_search_sse": (lambda: M.full_search_sse_batch(
            x10["blocks"], x10["areas"], 16, 16), lambda:
            M.full_search_sse_batch_ref(x10["blocks"], x10["areas"], 16, 16),
            fs_work(B16, 16, 16, R)),
        "sse_batch": (lambda: RD.sse_batch(x10["blocks"], x10["b16"]),
                      lambda: RD.sse_batch_ref(x10["blocks"], x10["b16"]),
                      dist_work("sse_batch", B16, 16, 16)),
        "sad_batch": (lambda: RD.sad_batch(x10["blocks"], x10["b16"]),
                      lambda: RD.sad_batch_ref(x10["blocks"], x10["b16"]),
                      dist_work("sad_batch", B16, 16, 16)),
        "satd_batch": (lambda: RD.satd_batch(x10["blocks"], x10["b16"], 8),
                       lambda: RD.satd_batch_ref(x10["blocks"], x10["b16"],
                                                 8),
                       dist_work("satd_batch", B16, 16, 16, 8)),
        "mode_costs": (lambda: IB.mode_costs_batch(
            *mi10["1080p 16x16"], 16, 16, 10), lambda:
            IB.mode_costs_batch_ref(*mi10["1080p 16x16"], 16, 16, 10),
            mode_work(B16, 16))}
    for n, (kern, plain, w) in timed.items():
        rec["ms"][n] = cuda_ms(torch, kern, reps)
        rec["plain_ms"][n] = cuda_ms(torch, plain, plain_reps)
        rec["work"][n] = w
    for tag, s in MODE_SIZES:
        B = mi10[tag][0].shape[0]
        rec["per_call"][f"mode_costs {tag}"] = {
            "B": B, "work": mode_work(B, s),
            "ms": cuda_ms(torch, lambda: IB.mode_costs_batch(
                *mi10[tag], s, s, 10), reps)}
    for (fs, fr), (blk, area) in x10["fs"].items():
        nb = blk.shape[0]
        rec["per_call"][f"full_search {fs}x{fs} R={fr}"] = {
            "B": nb, "work": fs_work(nb, fs, fs, fr),
            "ms": cuda_ms(torch, lambda: M.full_search_sse_batch(
                blk, area, fs, fs), reps),
            "plain_ms": cuda_ms(torch, lambda: M.full_search_sse_batch_ref(
                blk, area, fs, fs), plain_reps),
            "device_ms": call_device_ms(torch, lambda: M.full_search_sse_batch(
                blk, area, fs, fs), reps)}
    # K8 per kind (luma 16x16, chroma 8x8) and at each of the 16 luma
    # phases, K10 satd per tile on both grids: the device time of a call
    # (per kind and tile also cold: after an L2 flush)
    for plane, phases in K8_KINDS.items():
        x, s = (x10["luma"], 16) if plane == "luma" else (x10["chroma"], 8)
        n, nb = (8, True) if plane == "luma" else (4, False)
        for kind, (fx, fy) in enumerate(phases):
            nw = x.shape[0]
            rec["per_call"][f"mc_batch {plane} {s}x{s} kind {kind}"] = {
                "B": nw, "phase": (fx, fy),
                "work": mc_work(nw, s, s, n, fx, fy),
                "ms": cuda_ms(torch, lambda: IP.mc_batch(
                    x, fx, fy, s, s, 10, nb), reps),
                "device_ms": call_device_ms(torch, lambda: IP.mc_batch(
                    x, fx, fy, s, s, 10, nb), reps),
                "cold_device_ms": call_device_ms(torch, lambda: IP.mc_batch(
                    x, fx, fy, s, s, 10, nb), reps, cold=True)}
    rec["per_call"]["mc_batch luma phases device_ms"] = [
        call_device_ms(torch, lambda fx=fx, fy=fy: IP.mc_batch(
            x10["luma"], fx, fy, 16, 16, 10, True), reps)
        for fx, fy in LUMA_PHASES]
    # K10 sse and sad on every grid of DIST_GRIDS, warm and cold
    for s in DIST_GRIDS:
        a, b = dist_pair(x10, s)
        for n, fn in (("sse_batch", RD.sse_batch),
                      ("sad_batch", RD.sad_batch)):
            rec["per_call"][f"{n} {s}x{s}"] = {
                "B": a.shape[0], "work": dist_work(n, a.shape[0], s, s),
                "ms": cuda_ms(torch, lambda: fn(a, b), reps),
                "device_ms": call_device_ms(torch, lambda: fn(a, b), reps),
                "cold_device_ms": call_device_ms(torch, lambda: fn(a, b), reps,
                                                 cold=True)}
    for tag, tiles in SATD_TILES.items():
        a, b = dist_pair(x10, int(tag[:2]))
        for t in tiles:
            nb_, H_, W_ = a.shape
            rec["per_call"][f"satd_batch {tag} tile {t}"] = {
                "B": nb_, "work": dist_work("satd_batch", nb_, H_, W_, t),
                "ms": cuda_ms(torch, lambda: RD.satd_batch(a, b, t), reps),
                "device_ms": call_device_ms(
                    torch, lambda: RD.satd_batch(a, b, t), reps),
                "cold_device_ms": call_device_ms(
                    torch, lambda: RD.satd_batch(a, b, t), reps, cold=True)}
    rec["device_ms"]["mc_batch"] = call_device_ms(
        torch, lambda: IP.mc_batch(x10["luma"], 8, 8, 16, 16, 10, True), reps)
    for n in timed:
        rec["device_ms"][n] = call_device_ms(torch, timed[n][0], reps)
    rec["B"] = B16
    return rec, x10["fs"], {10: x10, 8: x8}


def api_phase(torch, kernels, clips, tmp, report):
    """The library entry points on the card: VVEncImpl streaming config
    1's and config 2's options (me_mode=device) against the batch
    encoder of the same options in this run, each streaming run in a
    launch window; ffapp.main on a .cfg of config 1's options against
    the CLI's stream of phase 4; the C shim through its C client (two
    416x240 pictures) against the Python C API path.  Returns the
    windows' launch counts."""
    from vvenc_tpu_torch import capi, capi_c, ffapp
    from vvenc_tpu_torch.__main__ import encoder_config_from
    from vvenc_tpu_torch.api import VVENC_OK, VVEncImpl
    from vvenc_tpu_torch.config import Preset, VvencTpuConfig, init_preset
    from vvenc_tpu_torch.config.config import apply_derived, set_param
    from vvenc_tpu_torch.decoder import decode_stream
    from vvenc_tpu_torch.encoder import IntraEncoder
    from vvenc_tpu_torch.utils.yuv_io import read_yuv
    windows = {}
    for tag, clip, w, h, n, extra, need in (
            ("api_config1", clips["config1"][0], 416, 240, 10,
             dict(intra_period=1, gop_size=1), PLAN_KERNELS),
            ("api_config2", clips["config2"][0], 832, 480, 17,
             dict(intra_period=0, gop_size=8, me_mode="device"),
             ("frame_me",))):
        frames = list(read_yuv(clip, w, h, 8, n))

        def config():
            cfg = VvencTpuConfig(width=w, height=h, qp=37)
            init_preset(cfg, Preset.FASTER)
            for k, v in extra.items():
                set_param(cfg, k, v)
            return cfg
        impl = VVEncImpl()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if impl.init(config()) != VVENC_OK:
            fail(f"{tag}: init failed: {impl.last_error()}")
        out = bytearray()
        for f in frames:
            au, _, rc = impl.encode(f)
            if rc != VVENC_OK:
                fail(f"{tag}: encode returned {rc}: {impl.last_error()}")
            out += au
        au, done, rc = impl.encode(None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if rc != VVENC_OK or not done:
            fail(f"{tag}: flush returned {rc}")
        stream = bytes(out + au)
        missing = [k for k in need if launches[k] < 1]
        if missing:
            fail(f"{tag}: {missing} never launched: {launches}")
        no_old_route(tag, launches)
        cfg = config()
        apply_derived(cfg)
        batch = IntraEncoder(encoder_config_from(cfg, None)).encode_sequence(
            frames)
        if stream != batch:
            fail(f"{tag}: the streamed stream ({len(stream)} bytes) != "
                 f"the batch encode ({len(batch)} bytes)")
        dec = decode_stream(stream)
        recs = impl._enc.recs_by_poc
        if len(dec) != n or any(
                not np.array_equal(fr.planes[c], recs[fr.poc][c])
                for fr in dec for c in range(3)):
            fail(f"{tag}: decoded stream != the encoder's reconstruction")
        windows[tag] = launches
        report[tag] = {"bytes": len(stream), "fps": n / secs,
                       "launches": launches}
        print(f"phase 4: {tag} VVEncImpl {w}x{h} x{n} streamed == batch "
              f"({len(stream)} bytes), decode == recon, {n / secs:.3f} fps "
              f"(init to flush), launches {nonzero(launches)}", flush=True)
    # ffapp on a cfg file of config 1's options == the CLI's stream
    clip1 = clips["config1"][0]
    cfgf = os.path.join(tmp, "config1.cfg")
    out = os.path.join(tmp, "ffapp.266")
    with open(cfgf, "w") as f:
        f.write(f"InputFile : {clip1}\nBitstreamFile : {out}\n"
                "SourceWidth : 416\nSourceHeight : 240\n"
                "FramesToBeEncoded : 10\nQP : 37\nIntraPeriod : 1\n"
                "Preset : faster\n")
    kernels.reset_launches()
    if ffapp.main(["-c", cfgf, "--verify"]) != 0:
        fail("ffapp: the encode returned non-zero (--verify mismatch?)")
    windows["ffapp"] = dict(kernels.launches)
    no_old_route("ffapp", windows["ffapp"])
    with open(out, "rb") as f:
        a = f.read()
    with open(os.path.join(tmp, "config1.266"), "rb") as f:
        b = f.read()
    if a != b:
        fail(f"ffapp: {len(a)} bytes != the CLI's {len(b)} bytes")
    print(f"phase 4: ffapp -c config1.cfg --verify: equal to the CLI "
          f"stream ({len(a)} bytes), launches {nonzero(windows['ffapp'])}",
          flush=True)
    # the C shim through its C client: two 416x240 pictures on the card
    params = "width=416;height=240;qp=37;intra_period=1;gop_size=1;" \
        "preset=faster"
    out = os.path.join(tmp, "capi.266")
    t0 = time.perf_counter()
    r = capi_c.run_client(out, params, 416, 240, 2)
    secs = time.perf_counter() - t0
    if r.returncode != 0 or "capi ok" not in r.stdout:
        fail(f"C shim client exited {r.returncode}:\n{r.stdout}\n"
             f"{r.stderr[-4000:]}")
    with open(out, "rb") as f:
        data = f.read()
    h = capi.capi_open(params)
    ref = b"".join(capi.capi_encode(h, y.tobytes(), u.tobytes(), v.tobytes())
                   for y, u, v in capi_c.client_frames(416, 240, 2))
    ref += capi.capi_flush(h)
    capi.capi_close(h)
    if data != ref:
        fail(f"C shim: {len(data)} bytes != the Python C API path's "
             f"{len(ref)}")
    if len(decode_stream(data)) != 2:
        fail("C shim: the stream does not decode to 2 pictures")
    report["capi"] = {"bytes": len(data), "client_seconds": secs}
    print(f"phase 4: C shim client (2 pictures 416x240, a process of its "
          f"own, {secs:.1f} s): {r.stdout.strip()}; equal to the Python C "
          f"API path, decoded", flush=True)
    return windows


def mesh_phase(torch, dev, kernels, clips, pic, report):
    """The mesh path on 4 positions (2 x 2) spread over the visible
    cards: the sharded programs against their unsharded runs, the
    MESH-hooked encodes against the unsharded streams of phase 4, then
    dryrun_multichip(4).  The kernels' counts are set to 0 just before
    each path run (each hooked encode, the dry run) and read just after,
    so the checks' own launches count nowhere.  Returns the counts of
    those runs: {"encodes": {tag: counts}, "dryrun": counts}."""
    from vvenc_tpu_torch import graft_entry
    from vvenc_tpu_torch.ops import intra_plan, intra_presel as S
    from vvenc_tpu_torch.parallel import mesh as M
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i % cards) for i in range(4)]
    mesh = M.make_mesh2d(devices)
    print(f"phase 4: mesh path, {mesh.describe()}: "
          f"{len(set(devices))} physical card(s), so nothing here measures "
          f"multi-card scaling", flush=True)
    H, W = pic.shape
    plane = padded_plane(torch, dev, pic)
    for s in (16, 64):
        got = M.search_step(*grid_inputs(plane, W, H, s, s), w=s, h=s,
                            qp=37)
        ref = M.search_step_ref(*grid_inputs(plane, W, H, s, s), w=s, h=s,
                                qp=37)
        for name, g, r in zip(("best", "levels", "recon", "bits", "sse"),
                              got, ref):
            if not torch.equal(g, r):
                fail(f"search_step {name} != its plain route at {s}x{s}")
    shapes, mtt = S.shapes_for_config(128, 2)
    pad = S.FramePresel.PAD
    for (w, h) in shapes:
        xs, ys, _, _ = S._class_grid(W, H, w, h, mtt)
        inputs = S.plane_inputs(plane, pad, xs, ys, w, h)
        costs, total = M.sharded_presel_costs(mesh, *inputs, w=w, h=h)
        ref = S.presel_costs(*inputs, w, h)
        if not torch.equal(costs, ref) or \
                int(total) != int(ref.min(dim=1).values.sum()):
            fail(f"sharded_presel_costs != unsharded at {w}x{h}")
        del inputs, costs, ref
    # what the hooks cost, in turns (unsharded, mesh, mesh, unsharded):
    # a 1080p FramePresel (upload, gather, launches, one fetch) and
    # config 1's plan batch (10 frames of 416x240, build_plans)
    from vvenc_tpu_torch.encoder.intra_encoder import lambda_for_qp
    csrcs = luma_frames(416, 240, 10, 10, seed=1)
    lm = float(np.float32(lambda_for_qp(37, 10)))
    ls = float(np.float32(lm) ** 0.5)
    hook_ms = {}
    for what, hook, call in (
            ("FramePresel 1080p", S, lambda: S.FramePresel(
                pic, 10, (shapes, mtt), device=dev)),
            ("build_plans config 1", intra_plan,
             lambda: intra_plan.build_plans(csrcs, 10, 64, 8, 43, [lm] * 10,
                                            [ls] * 10, device=dev))):
        times = {None: [], "mesh": []}
        for m in (None, mesh, mesh, None):
            hook.MESH = m
            try:
                t0 = time.perf_counter()
                call()
                times[None if m is None else "mesh"].append(
                    (time.perf_counter() - t0) * 1e3)
            finally:
                hook.MESH = None
        hook_ms[what] = {"unsharded_ms": min(times[None]),
                         "mesh_ms": min(times["mesh"])}
        print(f"phase 4: {what}: unsharded {min(times[None]):.3f} ms, on "
              f"the mesh {min(times['mesh']):.3f} ms (min of 2, in turns)",
              flush=True)
    report["hook_ms"] = hook_ms
    # two 1080p pictures, 16x16: [G, T, B] with T tile columns of blocks.
    # With 2 positions along "tiles" the shard-level roll by Tl = T / 2
    # pairs every block with the block half a picture to its right for
    # both T, so both give the same pairs; a roll by one tile column would
    # pair blocks W / T apart and fail the comparison.
    s, G = 16, 2
    two = [padded_plane(torch, dev, p) for p in luma_frames(W, H, 2, 10,
                                                            seed=61)]
    ins = [grid_inputs(pl, W, H, s, s) for pl in two]
    ny, nx = H // s, W // s
    for Tn in (2, 4):
        tl = Tn // mesh.shape["tiles"]

        def grid(k):
            x = torch.stack([i[k] for i in ins])           # [G, ny*nx, ...]
            x = x.reshape((G, ny, Tn, nx // Tn) + tuple(x.shape[2:]))
            return x.transpose(1, 2).reshape(
                (G, Tn, ny * (nx // Tn)) + tuple(x.shape[4:])).contiguous()
        src, tops, lefts = grid(0), grid(1), grid(2)
        B = src.shape[2]
        best, q, rec, per_gop, total = M.sharded_encode_step2d(
            mesh, w=s, h=s, qp=37)(src, src, tops, lefts)

        def flat(x):
            return x.reshape((G * Tn * B,) + tuple(x.shape[3:]))
        r1 = M.search_step(flat(src), flat(tops), flat(lefts), w=s, h=s,
                           qp=37)
        nbr = torch.roll(r1[2].reshape(G, Tn, B, s, s)[..., -1], tl,
                         dims=1).reshape(-1, s)
        L = lefts.shape[-1]
        l2 = torch.cat([nbr[:, :1], nbr, nbr[:, -1:].expand(-1, L - s - 1)],
                       dim=1)
        r2 = M.search_step(flat(src), flat(tops), l2, w=s, h=s, qp=37)
        better = r2[4] + r2[3].to(torch.int64) < r1[4] + r1[3].to(torch.int64)
        bits = torch.where(better, r2[3], r1[3])
        exp = [torch.where(better, r2[0], r1[0]),
               torch.where(better[:, None, None], r2[1], r1[1]),
               torch.where(better[:, None, None], r2[2], r1[2])]
        for name, g, e in zip(("best", "levels", "recon"), (best, q, rec),
                              exp):
            if not torch.equal(flat(g), e):
                fail(f"sharded_encode_step2d {name} != the replay at T={Tn}")
        if not torch.equal(per_gop, bits.reshape(G, -1).sum(dim=1)) or \
                int(total) != int(bits.sum()):
            fail(f"sharded_encode_step2d rate sums != the replay at T={Tn}")
        print(f"phase 4: sharded_encode_step2d on 2 {W}x{H} pictures, T={Tn} "
              f"({tl} tile column(s) per position): equal to the replay, "
              f"{int(better.sum())} of {len(better)} blocks kept the "
              f"re-trial", flush=True)
    del two, ins
    streams, enc_launches = {}, {}
    for tag, hook, need, (clip, w, h, frames, preset, plan) in (
            ("config1", intra_plan, PLAN_KERNELS, clips["config1"]),
            ("hd_faster", intra_plan, PLAN_KERNELS, clips["hd_faster"]),
            ("hd_medium", S, ("presel_costs_gathered",),
             clips["hd_medium"])):
        hook.MESH = mesh
        kernels.reset_launches()
        try:
            _, secs = encode(torch, f"{tag}_mesh", clip, w, h, frames, 37,
                             preset, ["--intra-period", "1"], plan)
        finally:
            hook.MESH = None
        launches = dict(kernels.launches)
        missing = [n for n in need if launches[n] < 1]
        if missing:
            fail(f"{tag} with {hook.__name__}.MESH: {missing} never "
                 f"launched: {launches}")
        no_old_route(f"{tag} with {hook.__name__}.MESH", launches)
        enc_launches[tag] = launches
        d = os.path.dirname(clip)
        with open(os.path.join(d, f"{tag}.266"), "rb") as f:
            a = f.read()
        with open(os.path.join(d, f"{tag}_mesh.266"), "rb") as f:
            b = f.read()
        if a != b:
            fail(f"{tag}: the stream with {hook.__name__}.MESH differs from "
                 f"the unsharded encode ({len(b)} vs {len(a)} bytes)")
        streams[tag] = {"bytes": len(a), "fps": frames / secs}
        print(f"phase 4: {tag} with {hook.__name__.split('.')[-1]}.MESH: "
              f"byte-identical to the unsharded stream ({len(a)} bytes), "
              f"decode == recon, {frames / secs:.3f} fps, launches "
              f"{launches}", flush=True)
    # the dry run is the path that reaches search_step, and so K6/K7
    kernels.reset_launches()
    graft_entry.dryrun_multichip(4)
    dry = dict(kernels.launches)
    missing = [n for n in MESH_KERNELS if dry[n] < 1]
    if missing:
        fail(f"dryrun_multichip(4): {missing} never launched: {dry}")
    print(f"phase 4: dryrun_multichip(4) launches {dry}", flush=True)
    counts = {"encodes": enc_launches, "dryrun": dry}
    report["mesh"] = {"describe": mesh.describe(), "cards": len(set(devices)),
                      "streams": streams, "launches": counts}
    return counts


def encode_phase(torch, kernels, tag, clip, w, h, frames, qp, preset,
                 extra, need, plan=False):
    """One main path: counts to 0, the encode, counts read; every kernel
    in `need` must have launched.  Returns (encoder, record)."""
    kernels.reset_launches()
    enc, secs = encode(torch, tag, clip, w, h, frames, qp, preset, extra,
                       plan)
    launches = dict(kernels.launches)
    missing = [n for n in need if launches[n] < 1]
    if missing:
        fail(f"{tag}: {missing} never launched: {launches}")
    no_old_route(tag, launches)
    print(f"phase 4: {tag} {w}x{h} x{frames} QP{qp} {preset} "
          f"{' '.join(extra)}: {frames / secs:.3f} fps (encode "
          f"{secs:.3f} s), launches {launches}, decode == recon",
          flush=True)
    return enc, {"fps": frames / secs, "encode_seconds": secs,
                 "launches": launches}


def tools_phase(clip, w, h, n, tmp) -> dict:
    """The tool twins on the card, on config 1's clip: the calibrate_plan
    twin's encodes (each a process of its own, all at once) of the
    variants "exact" (device_rd=off) and "plan-default" at its QPs, every
    summary line parsed, the rates falling as the QP rises, both curves
    and bd_delta printed; the bdrate twin's run_ours at QP 37, whose
    stream must be
    config 1's CLI stream of phase 4 (tmp/config1.266) bit for bit; and
    the bdrate twin without a reference encoder, which must raise naming
    the path it looked for.  Returns the record."""
    from concurrent.futures import ThreadPoolExecutor
    from vvenc_tpu_torch.tools import bdrate as TB
    from vvenc_tpu_torch.tools import calibrate_plan as TC
    t0 = time.time()
    names = ("exact", "plan-default")
    # the six encodes at once, a process each
    with ThreadPoolExecutor(len(names) * len(TC.QPS)) as ex:
        futs = {(name, qp): ex.submit(
            TC.encode, clip, w, h, n, qp, TC.VARIANTS[name],
            "off" if name == "exact" else "on", "cuda")
            for name in names for qp in TC.QPS}
        curves = {name: [futs[name, qp].result() for qp in TC.QPS]
                  for name in names}
    for name, pts in curves.items():
        kbps = [p[0] for p in pts]
        if not all(np.isfinite(v) for p in pts for v in p) or not all(
                a > b > 0 for a, b in zip(kbps, kbps[1:])):
            fail(f"calibrate_plan {name}: points {pts} at QPs {TC.QPS}")
    delta = TC.bd_delta(curves["exact"], curves["plan-default"])
    secs = time.time() - t0
    out = os.path.join(tmp, "bdrate")
    os.makedirs(out, exist_ok=True)
    bits, rec = TB.run_ours(clip, w, h, n, 37, "faster", 1, 0, out, "cuda")
    want = os.path.getsize(os.path.join(tmp, "config1.266")) * 8
    if bits != want:
        fail(f"bdrate run_ours QP 37: {bits} bits, config 1's CLI stream "
             f"{want}")
    src10 = [tuple(p.astype(np.uint16) << 2 for p in f)
             for f in TB.read_yuv8(clip, w, h, n)]
    psnr = TB.psnr_yuv(src10, rec, 10)
    missing = os.path.join(tmp, "no_reference", "vvencFFapp")
    try:
        TB.main(["--clip", clip, "--size", f"{w}x{h}", "--frames", str(n),
                 "--qps", "37", "--ref-bin", missing])
    except FileNotFoundError as e:
        if missing not in str(e):
            fail(f"bdrate without a reference encoder: {e}")
        refusal = str(e)
    else:
        fail("bdrate ran without a reference encoder")
    print(f"phase 4: tools: calibrate_plan twin on config 1's clip, "
          f"{len(curves) * len(TC.QPS)} encodes on cuda (at once) in "
          f"{secs:.1f} s: "
          + "; ".join(f"{k} {[(round(b, 2), round(p, 3)) for b, p in v]}"
                      for k, v in curves.items())
          + f" (kbps, Y dB at QPs {TC.QPS}); bd_delta of plan-default "
          f"against exact {delta:+.3f} %; bdrate twin run_ours QP 37: "
          f"{bits} bits (config 1's stream), PSNR-YUV {psnr:.4f} dB; "
          f"without a reference encoder: {refusal}", flush=True)
    return {"curves": curves, "bd_delta": delta, "seconds": secs,
            "run_ours_bits": bits, "run_ours_psnr_yuv": psnr}


def bench_twin_phase(clip, tmp) -> dict:
    """The bench twin's config-1 stage on config 1's clip (the stage's
    clip): the warm encode with --verify, then its timed passes, each
    with the launch counts set to 0 before and read after.  Fails unless
    the median pass ran at a rate above 0, launched the fused SATD and
    K3's reference entry and none of K1, K2 and the preds-form K3, and
    the passes' stream is config 1's CLI stream (tmp/config1.266).
    Returns the stage's record."""
    from vvenc_tpu_torch import bench as TB
    st = TB.STAGES[0]
    work = os.path.join(tmp, "bench_twin")
    os.makedirs(work)
    rec, stream, _ = TB.run_stage(st, clip, work, "cuda")
    launches = rec["launches"]
    if not rec["median_fps"] > 0:
        fail(f"bench twin {st.key}: {rec}")
    missing = [n for n in PLAN_KERNELS if not launches.get(n)]
    bad = [n for n in OLD_PLAN_KERNELS if launches.get(n)]
    if missing or bad:
        fail(f"bench twin {st.key}: {missing} never launched, {bad} "
             f"launched: {launches}")
    with open(os.path.join(tmp, "config1.266"), "rb") as f:
        if f.read() != stream:
            fail(f"bench twin {st.key}: the passes' stream is not config "
                 "1's CLI stream")
    print(f"phase 4: bench twin {st.key} (== config 1's CLI stream): "
          f"{json.dumps(rec)}", flush=True)
    return rec


def compare_plans(sizes, W, H, lmbdas, kern, plain):
    """Plan tables from the kernels' and the plain versions' modes/costs:
    equal, or a flip at a near-tie.  Returns the number of flips."""
    from vvenc_tpu_torch.ops import intra_plan as P
    F = len(lmbdas)
    mk = [{} for _ in range(F)]
    mr = [{} for _ in range(F)]
    tk = P._plan_tables(kern[0], kern[1], sizes, W, H, lmbdas, mk)
    tr = P._plan_tables(plain[0], plain[1], sizes, W, H, lmbdas, mr)
    flips = 0
    off = 0
    for s in sizes:
        n1 = (W // s) * (H // s)
        for f in range(F):
            a = tk[f].tables[(s, s)][5]
            b = tr[f].tables[(s, s)][5]
            c = plain[1][off + f * n1:off + (f + 1) * n1]
            for row in np.nonzero((a != b).any(axis=1))[0]:
                if a[row, 0] != b[row, 0]:
                    fail(f"plan mode0 differs at class {s}, frame {f}, "
                         f"block {row}")
                if a[row, 1] != b[row, 1]:
                    gap = abs(c[row, 1] - c[row, 0] * P.PLAN_MARGIN) / \
                        (c[row, 0] * P.PLAN_MARGIN)
                    if not gap < COST_RTOL:
                        fail(f"plan mode1 flip at class {s}, frame {f}, "
                             f"block {row}: gap {gap}")
                if a[row, 2] != b[row, 2]:
                    gap = max(mk[f][s].reshape(-1)[row],
                              mr[f][s].reshape(-1)[row])
                    if not gap < COST_RTOL:
                        fail(f"plan split flip at class {s}, frame {f}, "
                             f"block {row}: gap {gap}")
                flips += 1
        off += F * n1
    return flips


def encode(torch, tag, clip, w, h, frames, qp, preset, extra, plan=False):
    """One run of the port's CLI on the card with --verify; returns the
    encoder and the seconds of encode_sequence.  plan: device_rd must
    have resolved to "on"."""
    from vvenc_tpu_torch import __main__ as cli
    from vvenc_tpu_torch.decoder import decode_stream
    encs = []

    class Recorded(cli.IntraEncoder):
        def __init__(self, cfg):
            super().__init__(cfg)
            encs.append(self)

        def encode_sequence(self, frames_):
            t0 = time.perf_counter()
            out = super().encode_sequence(frames_)
            torch.cuda.synchronize()
            self.encode_seconds = time.perf_counter() - t0
            return out

    out = os.path.join(os.path.dirname(clip), f"{tag}.266")
    orig = cli.IntraEncoder
    cli.IntraEncoder = Recorded
    try:
        rc = cli.main(["-i", clip, "-o", out, "-s", f"{w}x{h}", "-q",
                       str(qp), "-f", str(frames), "--preset", preset,
                       "--device", "cuda", "--verify", *extra])
    finally:
        cli.IntraEncoder = orig
    if rc != 0:
        fail(f"{tag}: the CLI returned {rc} (--verify mismatch?)")
    enc = encs[-1]
    if plan and enc.cfg.device_rd != "on":
        fail(f"{tag}: device_rd resolved to {enc.cfg.device_rd!r}")
    if enc._plan_bank:
        fail(f"{tag}: plans of POCs {sorted(enc._plan_bank)} were never "
             "consumed by the searcher")
    with open(out, "rb") as f:
        dec = decode_stream(f.read())
    if len(dec) != frames:
        fail(f"{tag}: decoded {len(dec)} frames, expected {frames}")
    for fr in dec:
        rec = enc.recs_by_poc[fr.poc]
        for c in range(3):
            if not np.array_equal(fr.planes[c], rec[c]):
                fail(f"{tag}: decoded POC {fr.poc} plane {c} != recon")
    return enc, enc.encode_seconds


def old_k3_streams(torch, kernels, cases) -> None:
    """The all-intra faster encodes of `cases` ({tag: (clip, w, h,
    frames)}, already encoded under tag) again with the older package's
    K3 reference entry in device planning (intra_plan.plan_trial_refs
    swapped for the older wrapper, which launches the older kernel):
    each stream byte-identical to the current kernel's, and the current
    K3 never launched."""
    from vvenc_tpu_torch.ops import intra_plan as P
    current = P.plan_trial_refs
    P.plan_trial_refs = old_module("ops.intra_plan").plan_trial_refs
    try:
        for tag, (clip, w, h, frames) in cases.items():
            kernels.reset_launches()
            encode(torch, f"{tag}_old_k3", clip, w, h, frames, 37, "faster",
                   ["--intra-period", "1"], plan=True)
            if kernels.launches["plan_trial_refs"]:
                fail(f"{tag}: the current K3 launched in the older K3's run")
            folder = os.path.dirname(clip)
            with open(os.path.join(folder, f"{tag}.266"), "rb") as f:
                new = f.read()
            with open(os.path.join(folder, f"{tag}_old_k3.266"), "rb") as f:
                old = f.read()
            if new != old:
                fail(f"{tag}: the stream with the older K3 reference entry "
                     f"({len(old)} bytes) differs from the current one's "
                     f"({len(new)} bytes)")
            print(f"phase 4: {tag} with the older K3 reference entry: "
                  f"byte-identical ({len(new)} bytes)", flush=True)
    finally:
        P.plan_trial_refs = current


# the redesigned kernels that --old-csrc sets against an older build
# (their C entries kept their signatures)
OLD_SOURCES = ("frame_me", "mode_costs", "transform_batch", "full_search",
               "intra_pred_all", "satd_modes", "mc_batch", "dist_batch",
               "quant_batch", "plan_trial")
# the name the older checkout's package is imported under
OLD_PACKAGE = "old_vvenc_tpu_torch"


def old_package(csrc: str):
    """Imports the package of another checkout, the directory that holds
    `csrc` (for example the parent commit's, unpacked), as OLD_PACKAGE,
    and builds its OLD_SOURCES with its own kernels module (into its own
    _build/, one nvcc each, started together).  Its wrappers then launch
    its own kernels: the old public calls are its ops functions.  Returns
    (the older kernels module, {source: ptxas report})."""
    import importlib
    import importlib.util
    root = pathlib.Path(csrc).resolve().parent
    if OLD_PACKAGE not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            OLD_PACKAGE, root / "__init__.py",
            submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[OLD_PACKAGE] = pkg
        spec.loader.exec_module(pkg)
    okern = old_module("ops.kernels")
    return okern, okern.build(OLD_SOURCES)


def old_module(name: str):
    """Module `name` (for example "ops.interp") of the older package."""
    import importlib
    return importlib.import_module(f"{OLD_PACKAGE}.{name}")


def old_resources(okern, src: str, symbol: str, *args):
    """The older kernel's resources as its own vt_*_attrs query reports
    them; None where the older build has no such query."""
    try:
        return okern.resources(src, symbol, *args)
    except AttributeError:
        return None


def dev_str(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def dev_sum(vs):
    """The sum of device times, None when one of them was not measured."""
    vs = list(vs)
    return None if None in vs else sum(vs)


def profiled(torch, call, reps: int) -> dict:
    """{kernel name: (record count, device microseconds)} of reps runs of
    call() in one torch.profiler session (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0}


# the L2 flush of call_device_ms: its buffer and its kernels' names,
# learnt once a process
_FLUSH: dict = {}


def call_device_ms(torch, fn, reps: int, cold: bool = False):
    """Device milliseconds per fn() call from reps calls (torch.profiler's
    CUDA activity, after a warm-up call): for each kernel the profiler
    recorded, its launches a call k (its record count over reps, rounded)
    times its mean time a record, summed.  The profiler on the H100 has
    kept a few records fewer than there were launches of each kernel in a
    session (19 of 20 at first; 18, then 17 of 20 late in a run that
    times K3 and K4 per class), so a count may fall max(1, reps // 4)
    short of k * reps, which still leaves k unambiguous; a count
    further off, k = 0 or no record at all means records were lost.  The
    session is then taken once more; a second loss prints each kernel
    with its record count (or that none was recorded) and gives None
    (printed as not measured).  With cold, a
    read of twice the card's L2 cache (a reduction of its own, its
    kernels learnt once a process from a session of their own and left
    out) precedes
    each call, so that fn reads its inputs from device memory; a read,
    not a write, so that no dirty line is left for fn's misses to write
    back (after a write, the cold times held about the inputs' bytes
    again)."""
    skip, call = set(), fn
    if cold:
        if not _FLUSH:
            l2 = getattr(torch.cuda.get_device_properties(0),
                         "L2_cache_size", 50 << 20)
            flush = torch.zeros(2 * l2, dtype=torch.uint8, device="cuda")
            for _ in range(2):
                names = set(profiled(
                    torch, lambda: flush.sum(dtype=torch.int32), 3))
                if names:
                    _FLUSH.update(tensor=flush, names=names)
                    break
            else:
                print("  device time not measured: 3 calls of the L2 flush "
                      "recorded no device time", flush=True)
                return None
        flush, skip = _FLUSH["tensor"], _FLUSH["names"]

        def call():
            flush.sum(dtype=torch.int32)
            fn()
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        recs = {k: v for k, v in profiled(torch, call, reps).items()
                if k not in skip}
        total, odd = 0.0, []
        for key, (count, us) in recs.items():
            k = round(count / reps)
            if k < 1 or abs(count - k * reps) > max(1, reps // 4):
                odd.append(f"{key[:60]} x{count}")
            else:
                total += k * us / count
        if recs and not odd:
            return total / 1e3
        print("  device time " + ("not measured" if attempt else
                                  "lost, timed again") + f": {reps} calls "
              "recorded " + ("; ".join(odd) if odd else "no device time"),
              flush=True)
    return None


def in_turns(torch, old, new, reps) -> tuple:
    """(old ms, new ms): each timed twice, old, new, new, old (CUDA
    events, cuda_ms), and averaged."""
    o1, n1, n2, o2 = (cuda_ms(torch, f, reps) for f in (old, new, new, old))
    return (o1 + o2) / 2, (n1 + n2) / 2


def tr_cases(torch, dev, pic) -> dict:
    """K6's inputs at 10 bits for the old/new comparison: {tag: (w, h,
    residuals, coefficients)} for every class of TR_CLASSES on the 1080p
    picture pic, and search_step's shape."""
    from vvenc_tpu_torch.ops import transforms as T
    H, W = pic.shape
    plane = padded_plane(torch, dev, pic)
    out = {}
    for (w, h) in TR_CLASSES:
        resi = residuals(torch, plane, W, H, w, h, 10)
        out[f"{w}x{h}"] = (w, h, resi, T.fwd_transform_batch(resi, w, h, 10))
    w, h, resi, ck = out["16x16"]
    B = SEARCH_STEP_BLOCKS
    out["search_step 16x16"] = (w, h, resi[:B].contiguous(),
                                ck[:B].contiguous())
    return out


def fs_int_cases(torch, dev, pic) -> dict:
    """K9's inputs on its integer route for the old/new comparison:
    {tag: (h, w, R, blocks, areas)}: a 0 / 4095 checkerboard (12 bits,
    every group of the persistent grid staged again as int32) at 16x16,
    R = 16 on the 1080p grid's 8,040 blocks, and the 1080p 6x6 grid at
    R = 8 of the 10-bit picture pic (w not a multiple of 4: a thread
    block a block)."""
    H, W = pic.shape
    B, s, R = (H // 16) * (W // 16), 16, 16
    a = s + 2 * R
    yy, xx = np.mgrid[:a, :a]
    board = torch.from_numpy(((yy + xx) % 2 * 4095).astype(np.int32)).to(dev)
    areas = board.expand(B, a, a).contiguous()
    blocks = (4095 - board[R:R + s, R + 1:R + 1 + s]).expand(B, s, s) \
        .contiguous()
    return {"16x16 R=16 12-bit checkerboard": (s, s, R, blocks, areas),
            "6x6 R=8": (6, 6, 8, grid_windows(torch, dev, pic, 6, 6, 0, 0),
                        grid_windows(torch, dev, pic, 6, 22, -8, -8))}


def kernel_pair(okern, src: str, symbol: str, argtypes, args_of,
                before_old=None):
    """call(v) for old_new_case: the current (v == "new") or the older
    (v == "old") C entry `symbol` of source `src` on the arguments
    args_of(v), the launch checked; before_old(), where given, runs
    before each old launch (an output the old kernel adds into, zeroed)."""
    from vvenc_tpu_torch.ops import kernels
    fns = {"new": (kernels, kernels.function(src, symbol, argtypes)),
           "old": (okern, okern.function(src, symbol, argtypes))}

    def call(v):
        if v == "old" and before_old is not None:
            before_old()
        mod, fn = fns[v]
        err = fn(*args_of(v))
        if err:
            fail(f"{v} {symbol}: error {err} "
                 f"({mod._LIBS[src].vt_error_string(err).decode()})")
    return call


def old_new_case(torch, label, call, outs, public, bound, reps, turn=None,
                 rounds=1, device=None, cold=False, timed=True, same=None,
                 **extra):
    """One shape of the old/new comparison.  call(v) launches the old (v
    == "old") or the new kernel with the wrapper's arguments into outs[v]
    (a tensor or a tuple of them); the run fails unless both outputs are
    equal (same(old, new) in place of torch.equal on every tensor where
    given).  Unless timed is False, returns the record: both timed in
    turns, old, new, new, old (`rounds` rounds of `turn` calls, reps by
    default, averaged), the device time of one call alone (device(v) in
    place of call(v) where given; with cold also after an L2 flush), the
    public function's time, the bound (ms) and `extra`."""
    call("old")
    call("new")
    torch.cuda.synchronize()
    pair = [o if isinstance(o, tuple) else (o,)
            for o in (outs["old"], outs["new"])]
    if not (same(*pair) if same is not None else
            all(torch.equal(a, b) for a, b in zip(*pair))):
        fail(f"{label}: the new kernel's output != the old kernel's")
    if not timed:
        return None
    turn = turn or reps
    rs = [in_turns(torch, lambda: call("old"), lambda: call("new"), turn)
          for _ in range(rounds)]
    device = device or call
    rec = {"old_ms": sum(r[0] for r in rs) / rounds,
           "ms": sum(r[1] for r in rs) / rounds,
           "public_ms": cuda_ms(torch, public, turn),
           "old_device_ms": call_device_ms(torch, lambda: device("old"),
                                           reps),
           "device_ms": call_device_ms(torch, lambda: device("new"), reps),
           "bound_ms": bound, **extra}
    if cold:
        rec["old_cold_device_ms"] = call_device_ms(
            torch, lambda: device("old"), reps, cold=True)
        rec["cold_device_ms"] = call_device_ms(
            torch, lambda: device("new"), reps, cold=True)
    return rec


def old_new_phase(torch, dev, okern, me_cases, mi10, k6_cases, fs_cases,
                  reps) -> dict:
    """K5, K6, K9 and K11 against the older package's kernels (okern,
    old_package) in one call, each shape through old_new_case (K6 at
    search_step's shape 2000 calls a turn; the old K11 into the zeroed
    output it needs), then the old kernels' resources.
    me_cases: {tag: (src plane, ref plane, W, H, R)}; mi10: K11's inputs
    by MODE_SIZES tag; k6_cases: tr_cases; fs_cases: {tag: (h, w, R,
    blocks, areas)}.  Returns the record."""
    from vvenc_tpu_torch.ops import intra_batch as IB
    from vvenc_tpu_torch.ops import kernels
    from vvenc_tpu_torch.ops import me as M
    from vvenc_tpu_torch.ops import transforms as T
    rec = {"frame_me": {}, "mode_costs": {}, "full_search_sse": {},
           "resources": {}}
    for tag, (sp, rp, W, H, R) in me_cases.items():
        B = (W // M.ME_BS) * (H // M.ME_BS)
        outs = {v: (torch.empty((B, 2), dtype=torch.int32, device=dev),
                    torch.empty((B,), dtype=torch.float32, device=dev))
                for v in ("old", "new")}
        call = kernel_pair(okern, "frame_me", "vt_frame_me", M._K5_ARGS,
                           lambda v: (
                               sp.data_ptr(), rp.data_ptr(), sp.shape[1],
                               W // M.ME_BS, H // M.ME_BS, R,
                               outs[v][0].data_ptr(), outs[v][1].data_ptr(),
                               kernels.stream_ptr(outs[v][0])))
        rec["frame_me"][tag] = old_new_case(
            torch, f"K5 frame_me ({tag})", call, outs,
            lambda: M.frame_me(sp, rp, W, H, R),
            bound_ms(*me_work(W, H, R))[0], reps)
    for tag, s in MODE_SIZES:
        src, rm, tops, lefts = mi10[tag]
        B = src.shape[0]
        outs = {v: torch.zeros((B, 67), dtype=torch.int32, device=dev)
                for v in ("old", "new")}
        row_start, filt, transposed = IB._device_tables(s, dev)
        call = kernel_pair(
            okern, "mode_costs", "vt_mode_costs", IB._K11_ARGS,
            lambda v: (src.data_ptr(), rm.data_ptr(), tops.data_ptr(),
                       tops.shape[1], lefts.data_ptr(), lefts.shape[1],
                       outs[v].data_ptr(), B, rm.shape[2], s, 10,
                       row_start.data_ptr(), filt.data_ptr(),
                       transposed.data_ptr(), kernels.stream_ptr(outs[v])),
            before_old=lambda: outs["old"].zero_())
        rec["mode_costs"][tag] = old_new_case(
            torch, f"K11 mode_costs ({tag})", call, outs,
            lambda: IB.mode_costs_batch(src, rm, tops, lefts, s, s, 10),
            bound_ms(*mode_work(B, s))[0], reps)
    for n, inverse in (("fwd_transform_batch", False),
                       ("inv_transform_batch", True)):
        rec[n] = {}
        for tag, (w, h, resi, ck) in k6_cases.items():
            x = ck if inverse else resi
            outs = {v: torch.empty_like(x) for v in ("old", "new")}
            # the arguments the wrappers pass (ops/transforms.k6_launch)
            launch = {v: T.k6_launch(x, outs[v], w, h, 10, inverse)
                      for v in outs}
            sym, argt = launch["new"][:2]
            call = kernel_pair(okern, "transform_batch", sym, argt,
                               lambda v: launch[v][2])
            rec[n][tag] = old_new_case(
                torch, f"K6 {n} ({tag})", call, outs,
                lambda: getattr(T, n)(x, w, h, 10),
                tr_bound_ms(n, x.shape[0], w, h)[0], reps,
                turn=2000 if tag.startswith("search_step") else reps,
                int32_bound_ms=bound_ms(*tr_work(n, x.shape[0], w, h))[0])
    for tag, (bh, bw, R, blk, area) in fs_cases.items():
        B = blk.shape[0]
        outs = {v: torch.empty((B, 2 * R + 1, 2 * R + 1), dtype=torch.float32,
                               device=dev) for v in ("old", "new")}
        call = kernel_pair(okern, "full_search", "vt_full_search_sse",
                           M._K9_ARGS, lambda v: (
                               blk.data_ptr(), area.data_ptr(),
                               outs[v].data_ptr(), B, bh, bw, area.shape[1],
                               area.shape[2], kernels.stream_ptr(outs[v])))
        float_route = "checkerboard" not in tag and bw % 4 == 0
        rec["full_search_sse"][tag] = old_new_case(
            torch, f"K9 full_search_sse ({tag})", call, outs,
            lambda: M.full_search_sse_batch(blk, area, bh, bw),
            fs_bound_ms(B, bh, bw, R, float_route)[0], reps,
            int32_bound_ms=bound_ms(*fs_work(B, bh, bw, R))[0])
    rows = [("frame_me", "frame_me", "vt_frame_me_attrs", ())]
    rows += [(f"mode_costs {s}x{s}", "mode_costs", "vt_mode_costs_attrs",
              (s,)) for s in (4, 8, 16, 32, 64)]
    for label, src, symbol, args in rows + resource_rows():
        # an older build may lack a kernel's resource query
        if src in OLD_SOURCES and label not in rec["resources"]:
            r = old_resources(okern, src, symbol, *args)
            if r is not None:
                rec["resources"][label] = r
    return rec


def old_new_k12(torch, dev, okern, cases, reps) -> dict:
    """K1 and K2 against the older package's kernels (okern) on every
    case of k12_cases through old_new_case with the wrappers' arguments
    (at search_step's shape three rounds of turns of 2000 calls).
    Returns {entry: {tag: record}}."""
    from vvenc_tpu_torch.ops import intra_presel as S
    from vvenc_tpu_torch.ops import kernels
    from vvenc_tpu_torch.ops.tables import device_tables
    rec = {"intra_pred_all": {}, "satd_modes": {}}
    for tag, (w, h, blocks, tops, lefts) in cases.items():
        B = blocks.shape[0]
        t = device_tables(w, h, dev)
        preds = {v: torch.empty((B, 67, h, w), dtype=torch.int16, device=dev)
                 for v in ("old", "new")}
        costs = {v: torch.empty((B, 67), dtype=torch.int32, device=dev)
                 for v in ("old", "new")}
        # the wrappers' arguments (ops/intra_presel.predict_all_modes,
        # satd_batch); K2 reads the new kernel's predictions
        k1_args = lambda v: (  # noqa: E731
            tops.data_ptr(), tops.shape[1], lefts.data_ptr(),
            lefts.shape[1], preds[v].data_ptr(), B, w, h, 10,
            t["rm_flat"].data_ptr(), t["row_start"].data_ptr(),
            t["filt"].data_ptr(), t["mode_info"].data_ptr(),
            t["pdpc_wl"].data_ptr(), t["side_flat"].data_ptr(), t["LPAD"],
            t["LR"], t["TM"], t["B0"], kernels.stream_ptr(preds[v]))
        k2_args = lambda v: (  # noqa: E731
            blocks.data_ptr(), preds["new"].data_ptr(), costs[v].data_ptr(),
            B * 67, 67, w, h, kernels.stream_ptr(costs[v]))
        turn = 2000 if tag.startswith("search_step") else reps
        for n, argt, args_of, outs, public in (
                ("intra_pred_all", S._K1_ARGS, k1_args, preds,
                 lambda: S.predict_all_modes(tops, lefts, w, h, 10)),
                ("satd_modes", S._K2_ARGS, k2_args, costs,
                 lambda: S.satd_batch(blocks, preds["new"], w, h))):
            # host-bound calls drift between turns: at search_step's
            # shape three rounds of turns, averaged
            rec[n][tag] = old_new_case(
                torch, f"{n} ({tag})",
                kernel_pair(okern, n, f"vt_{n}", argt, args_of), outs,
                public, bound_ms(*k12_work(n, B, w, h))[0], reps, turn=turn,
                rounds=3 if turn > reps else 1, B=B, w=w, h=h)
    return rec


def old_new_k8k10(torch, dev, okern, x10, x8, reps) -> dict:
    """K8 and K10's satd entry against the older package's kernels
    (okern) through old_new_case: every phase of run_batch_ops (K8 luma
    16x16 and chroma 8x8) and every tile of SATD_TILES, outputs equal at 8
    and 10 bits, timed at 10 bits (the old satd into an output zeroed in
    the same call, as its wrapper did, and its device time without the
    zero-fill); K8_KINDS' phases and satd tile 8 also cold.  Then the
    public calls in 2000-call turns, three rounds: the current wrappers
    against the older package's own (its ops/interp.mc_batch and
    ops/rdcost.satd_batch) at K8's phase (8, 8) and satd tile 8, on the
    1080p 16x16 grid.  x10, x8: run_batch_ops' inputs.
    Returns {entry: {tag: record}}."""
    import ctypes
    from vvenc_tpu_torch.ops import interp as IP
    from vvenc_tpu_torch.ops import kernels
    from vvenc_tpu_torch.ops import rdcost as RD
    rec = {"mc_batch": {}, "satd_batch": {}, "public": {}}
    cases = [("luma", fx, fy) for fx, fy in LUMA_PHASES] + \
        [("chroma", fx, fy) for fx, fy in CHROMA_PHASES]
    sargs = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    for bd, x in ((10, x10), (8, x8)):
        for plane, fx, fy in cases:
            luma = plane == "luma"
            win, s = (x["luma"], 16) if luma else (x["chroma"], 8)
            B = win.shape[0]
            args = IP._k8_args(fx, fy, bd, luma)
            outs = {v: torch.empty((B, s, s), dtype=torch.int32, device=dev)
                    for v in ("old", "new")}
            call = kernel_pair(okern, "mc_batch", "vt_mc_batch", IP._K8_ARGS,
                               lambda v: (win.data_ptr(), outs[v].data_ptr(),
                                          B, s, s, *args,
                                          kernels.stream_ptr(outs[v])))
            r = old_new_case(
                torch, f"K8 mc_batch ({plane} {fx},{fy}, {bd}-bit)", call,
                outs, lambda: IP.mc_batch(win, fx, fy, s, s, 10, luma),
                bound_ms(*mc_work(B, s, s, 8 if luma else 4, fx, fy))[0],
                reps, cold=(fx, fy) in K8_KINDS[plane], timed=bd == 10, B=B)
            if r is not None:
                rec["mc_batch"][f"{plane} {s}x{s} {fx},{fy}"] = r
        for tag, tiles in SATD_TILES.items():
            a, b = (x["blocks"], x["b16"]) if tag == "16x16" else \
                (x["a64"], x["b64"])
            B, H, W = a.shape
            for t in tiles:
                outs = {v: torch.empty((B,), dtype=torch.int32, device=dev)
                        for v in ("old", "new")}

                def args_of(v):
                    return (a.data_ptr(), b.data_ptr(), outs[v].data_ptr(), B,
                            H, W, t, kernels.stream_ptr(outs[v]))
                r = old_new_case(
                    torch, f"K10 satd_batch ({tag} tile {t}, {bd}-bit)",
                    kernel_pair(okern, "dist_batch", "vt_satd_batch", sargs,
                                args_of,
                                before_old=lambda: outs["old"].zero_()),
                    outs, lambda: RD.satd_batch(a, b, t),
                    bound_ms(*dist_work("satd_batch", B, H, W, t))[0], reps,
                    device=kernel_pair(okern, "dist_batch", "vt_satd_batch",
                                       sargs, args_of),
                    cold=t == 8, timed=bd == 10, B=B)
                if r is not None:
                    rec["satd_batch"][f"{tag} tile {t}"] = r
    old_ip, old_rd = old_module("ops.interp"), old_module("ops.rdcost")
    win, blk, b16 = x10["luma"], x10["blocks"], x10["b16"]
    for tag, old, new in (
            ("mc_batch luma 16x16 8,8",
             lambda: old_ip.mc_batch(win, 8, 8, 16, 16, 10, True),
             lambda: IP.mc_batch(win, 8, 8, 16, 16, 10, True)),
            ("satd_batch 16x16 tile 8", lambda: old_rd.satd_batch(blk, b16, 8),
             lambda: RD.satd_batch(blk, b16, 8))):
        if not torch.equal(old(), new()):
            fail(f"public {tag}: the new wrapper's output != the old one's")
        rounds = [in_turns(torch, old, new, 2000) for _ in range(3)]
        rec["public"][tag] = {"old_ms": [r[0] for r in rounds],
                              "ms": [r[1] for r in rounds]}
    return rec


def old_new_k7k10(torch, dev, okern, x10, x8, k6_cases, reps) -> dict:
    """K7 (quant, dequant) and K10's sse and sad entries against the older
    package's kernels (okern) through old_new_case with the wrappers'
    arguments: K10 on every grid of DIST_GRIDS at 8 and 10 bits (outputs
    equal), timed at 10 bits, warm and cold; K7 at 10 bits, QP 37, intra,
    on every class of k6_cases' residuals' coefficients (quant) and their
    levels (dequant), outputs equal, timed at 16x16, warm and cold.  The
    calls are host-bound: 2000 calls a turn.  Then the public
    calls in 2000-call turns, three rounds, the current wrappers against
    the older package's own: sse and sad on the 4x4 and 16x16 grids,
    quant and dequant at 16x16.  x10, x8: run_batch_ops' inputs.
    Returns {entry: {tag: record}}."""
    import ctypes
    from vvenc_tpu_torch.ops import kernels
    from vvenc_tpu_torch.ops import rdcost as RD
    from vvenc_tpu_torch.ops import transforms as T
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rec = {"sse_batch": {}, "sad_batch": {}, "quant_batch": {},
           "dequant_batch": {}, "public": {}}
    for bd, x in ((10, x10), (8, x8)):
        for s in DIST_GRIDS:
            a, b = dist_pair(x, s)
            B = a.shape[0]
            for n, dtype in (("sse_batch", torch.float32),
                             ("sad_batch", torch.int32)):
                outs = {v: torch.empty((B,), dtype=dtype, device=dev)
                        for v in ("old", "new")}
                call = kernel_pair(
                    okern, "dist_batch", f"vt_{n}", [P, P, P, L, I, I, P],
                    lambda v: (a.data_ptr(), b.data_ptr(), outs[v].data_ptr(),
                               B, s, s, kernels.stream_ptr(outs[v])))
                r = old_new_case(
                    torch, f"K10 {n} ({s}x{s}, {bd}-bit)", call, outs,
                    lambda: getattr(RD, n)(a, b),
                    bound_ms(*dist_work(n, B, s, s))[0], reps, turn=2000,
                    cold=True, timed=bd == 10, B=B)
                if r is not None:
                    rec[n][f"{s}x{s}"] = r
    qp, bd = 37, 10
    for tag, (w, h, _, ck) in k6_cases.items():
        if tag.startswith("search_step"):
            continue
        qk = T.quant_batch(ck, w, h, qp, bd)
        n_ = ck.numel()
        for n, x, params, argt in (
                ("quant_batch", ck, T._quant_params(w, h, qp, bd, True),
                 [P, P, L, I, I, I, P]),
                ("dequant_batch", qk, T._dequant_params(w, h, qp, bd),
                 [P, P, L, I, I, P])):
            outs = {v: torch.empty_like(x) for v in ("old", "new")}
            call = kernel_pair(
                okern, "quant_batch", f"vt_{n}", argt,
                lambda v: (x.data_ptr(), outs[v].data_ptr(), n_, *params,
                           kernels.stream_ptr(outs[v])))
            r = old_new_case(
                torch, f"K7 {n} ({tag})", call, outs,
                lambda: getattr(T, n)(x, w, h, qp, bd),
                bound_ms(*tr_work(n, x.shape[0], w, h))[0], reps,
                turn=2000, cold=True, timed=tag == "16x16", B=x.shape[0])
            if r is not None:
                rec[n][tag] = r
    old_rd, old_t = old_module("ops.rdcost"), old_module("ops.transforms")
    w, h, _, ck = k6_cases["16x16"]
    qk = T.quant_batch(ck, w, h, qp, bd)
    publics = [(f"{n} {s}x{s}", (lambda n=n, a=a, b=b:
                                 getattr(old_rd, n)(a, b)),
                (lambda n=n, a=a, b=b: getattr(RD, n)(a, b)))
               for s in (4, 16) for a, b in (dist_pair(x10, s),)
               for n in ("sse_batch", "sad_batch")]
    publics += [("quant_batch 16x16", lambda: old_t.quant_batch(
        ck, w, h, qp, bd), lambda: T.quant_batch(ck, w, h, qp, bd)),
        ("dequant_batch 16x16", lambda: old_t.dequant_batch(
            qk, w, h, qp, bd), lambda: T.dequant_batch(qk, w, h, qp, bd))]
    for tag, old, new in publics:
        if not torch.equal(old(), new()):
            fail(f"public {tag}: the new wrapper's output != the old one's")
        rounds = [in_turns(torch, old, new, 2000) for _ in range(3)]
        rec["public"][tag] = {"old_ms": [r[0] for r in rounds],
                              "ms": [r[1] for r in rounds]}
    return rec


def print_public(rec: dict, turn: int = 2000) -> None:
    """The public calls of an old_new_k* record, old against new."""
    for tag, r in rec["public"].items():
        print(f"  public {tag}, the older package's wrapper against the "
              f"current one, {turn}-call turns, three rounds: old "
              + ", ".join(f"{v:.5f}" for v in r["old_ms"]) + " ms; new "
              + ", ".join(f"{v:.5f}" for v in r["ms"]) + " ms")


def print_old_new(cmp: dict, names) -> None:
    """One line per shape of the old/new records of entries `names`."""
    for n in names:
        for tag, r in cmp[n].items():
            yard = r.get("int32_bound_ms")
            cold = "" if "cold_device_ms" not in r else (
                f"; cold {dev_str(r['old_cold_device_ms'])} -> "
                f"{dev_str(r['cold_device_ms'])}")
            print(f"  {n} {tag}: {r['old_ms']:.4f} -> {r['ms']:.4f} ms "
                  f"(device {dev_str(r['old_device_ms'])} -> "
                  f"{dev_str(r['device_ms'])}{cold}; public "
                  f"{r['public_ms']:.4f}; bound {r['bound_ms']:.5f}"
                  + ("" if yard is None else
                     f", int32 yardstick {yard:.5f}") + ")")


def print_ptxas(built: dict) -> None:
    """ptxas's register and spill lines of each kernel source built."""
    for n, log in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}")


def write_json(json_path, report: dict) -> None:
    if json_path:
        path = pathlib.Path(json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1))


def resource_rows() -> list:
    """(label, source, vt_*_attrs symbol, int arguments) of every kernel
    whose resources phase 3 prints: K3 (both entries) and K4 (both
    entries) per class, K5, K11 per block size, K6 (both entries) per
    class, K9 at its timed shapes, K1 and K2 per class of TR_CLASSES, K8
    per kind at luma 16x16 and chroma 8x8 (and luma 128x128 kind 3), K10
    satd per tile of SATD_TILES, K10 sse and sad per grid of DIST_GRIDS,
    K7 quant and dequant on the 16-byte and the 4-byte path."""
    from vvenc_tpu_torch.ops import intra_presel as S
    from vvenc_tpu_torch.ops.tables import presel_mode_tables
    rows = [(f"{name} {s}x{s}", "plan_trial", f"vt_{name}_attrs", (s, s))
            for name in ("plan_trial", "plan_trial_refs")
            for s in (4, 8, 16, 32, 64)]
    rows += [(f"presel_costs{'_gathered' if g else ''} {w}x{h}",
              "presel_costs", "vt_presel_costs_attrs",
              (w, h, g, presel_mode_tables(w, h, 2 * w + 3, 2 * h + 3)["LM"]))
             for (w, h) in S.shapes_for_config(128, 2)[0] for g in (0, 1)]
    rows.append(("frame_me", "frame_me", "vt_frame_me_attrs", ()))
    rows += [(f"mode_costs {s}x{s}", "mode_costs", "vt_mode_costs_attrs",
              (s,)) for s in (4, 8, 16, 32, 64)]
    rows += [(f"transform_batch {n} {w}x{h}", "transform_batch",
              "vt_transform_batch_attrs", (w, h, inv))
             for (w, h) in TR_CLASSES for inv, n in ((0, "fwd"), (1, "inv"))]
    rows += [(f"full_search {s}x{s} R={R}", "full_search",
              "vt_full_search_attrs", (s, s, s + 2 * R, s + 2 * R))
             for s, R in FS_SHAPES]
    # a shape the float route does not take (w not a multiple of 4)
    rows.append(("full_search 6x6 R=8", "full_search", "vt_full_search_attrs",
                 (6, 6, 22, 22)))
    rows += [(f"{n} {w}x{h}", n, f"vt_{n}_attrs", (w, h))
             for n in ("intra_pred_all", "satd_modes")
             for (w, h) in TR_CLASSES]
    rows += [(f"mc_batch {plane} {s}x{s} kind {kind}", "mc_batch",
              "vt_mc_batch_attrs", (s, s, n, kind))
             for plane, s, n in (("luma", 16, 8), ("chroma", 8, 4))
             for kind in range(4)]
    rows.append(("mc_batch luma 128x128 kind 3", "mc_batch",
                 "vt_mc_batch_attrs", (128, 128, 8, 3)))
    rows += [(f"satd_batch {tag} tile {t}", "dist_batch",
              "vt_dist_batch_attrs", (t, int(tag[:2]), int(tag[:2])))
             for tag, tiles in SATD_TILES.items() for t in tiles]
    rows += [(f"{n} {g}x{g}", "dist_batch", "vt_sse_sad_attrs",
              (int(n == "sse_batch"), g, g))
             for n in ("sse_batch", "sad_batch") for g in DIST_GRIDS]
    rows += [(f"{n} {'16-byte' if vec else '4-byte'}", "quant_batch",
              "vt_quant_batch_attrs", (int(n == "dequant_batch"), vec))
             for n in ("quant_batch", "dequant_batch") for vec in (1, 0)]
    return rows


def resource_line(label: str, r: dict) -> str:
    return (f"  resources {label}: {r['registers']} registers, shared "
            f"{r['static_smem']} + {r['dynamic_smem']} B, {r['threads']} "
            f"threads, {r['blocks_per_sm']} blocks/SM, local "
            f"{r['local_bytes']} B")


def print_resources() -> dict:
    """Prints and returns the resources of K1's to K11's kernels (the
    rows of resource_rows: registers, shared
    memory, threads, resident blocks per SM and local memory, from each
    source's vt_*_attrs query on this card)."""
    from vvenc_tpu_torch.ops import kernels
    out = {}
    for label, src, symbol, args in resource_rows():
        r = out[label] = kernels.resources(src, symbol, *args)
        print(resource_line(label, r), flush=True)
    return out


def plan_shapes() -> list:
    """Phase 3's planning shapes: (tag, label, luma frames, bit depth, the
    plan's QP, lambda, classes, timing calls, plain timing calls) of 4
    smooth 1920x1080 frames at 8 and at 10 bits (every class 4..64),
    config 1's plan batch (10 frames of 416x240, 10-bit internal, classes
    min QT .. 64) and one of its pictures (a streaming encode's plan).
    QP 37 codes its I slices at 37 + intra_qp_offset; the plan's QP is
    that plus 6 per bit above 8."""
    from vvenc_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                       lambda_for_qp)
    from vvenc_tpu_torch.ops import intra_plan as P
    slice_qp = 37 + EncoderConfig.intra_qp_offset
    out = []
    for bd in (8, 10):
        out.append((f"1080p_{bd}", f"1920x1080 x4, {bd}-bit",
                    luma_frames(1920, 1080, 4, bd, seed=11 + bd), bd,
                    slice_qp + 6 * (bd - 8),
                    float(np.float32(lambda_for_qp(slice_qp, bd))),
                    (4, 8, 16, 32, 64), 3, 0))
    cw, ch, cbd = 416, 240, 10
    csizes = tuple(P._plan_sizes(cw, ch, 64, EncoderConfig.min_qt))
    clmbda = float(np.float32(lambda_for_qp(slice_qp, cbd)))
    csrcs = luma_frames(cw, ch, 10, cbd, seed=1)
    for tag, frames, plain_reps in (("config1_batch", csrcs, 5),
                                    ("config1_picture", csrcs[:1], 0)):
        out.append((tag, f"config 1's plan "
                    f"{'batch' if len(frames) > 1 else 'picture'} "
                    f"({len(frames)} x {cw}x{ch}, {cbd}-bit)", frames, cbd,
                    slice_qp + 6 * (cbd - 8), clmbda, csizes, 50,
                    plain_reps))
    return out


def class_batch(torch, dev, srcs, s, lmbda):
    """Planning's inputs of class s on frames srcs (the route's own
    tiling, ops/intra_plan._class_inputs): blocks, tops, lefts, lambda
    and lambda_sad per candidate."""
    from vvenc_tpu_torch.ops import intra_plan as P
    H, W = srcs[0].shape
    planes = torch.from_numpy(np.stack(
        [np.pad(x, P.PAD, mode="edge") for x in srcs]).astype(np.int16)
    ).to(dev)
    blocks, tops, lefts = P._class_inputs(planes, s, W, H)
    B = blocks.shape[0]
    lm = torch.full((B,), lmbda, dtype=torch.float32, device=dev)
    ls = torch.full((B,), float(np.float32(lmbda) ** 0.5),
                    dtype=torch.float32, device=dev)
    return blocks, tops, lefts, lm, ls


def old_new_k3(torch, dev, okern) -> dict:
    """K3's two entries against the older package's kernels (okern) on
    every class of plan_shapes() through old_new_case with the wrappers'
    arguments (the reference entry with every constant on its own,
    vt_plan_trial_refs, as the older wrapper passed them:
    intra_plan.refs_launch_args): modes equal and costs within COST_RTOL
    of the old kernel's (the f32 log2 sums run in another order); both
    timed in turns,
    device time warm and cold.  The run fails where a class of the
    reference entry takes more device time than the old kernel's, warm
    or cold, by more than K3_NOISE.  Then the public plan_trial_refs on
    config 1's batch and picture, the older package's wrapper against
    the current one in turns of 200 calls, three rounds.  Returns
    {entry: {tag: record}}."""
    from vvenc_tpu_torch.ops import intra_plan as P
    from vvenc_tpu_torch.ops import intra_presel as S
    from vvenc_tpu_torch.ops import kernels
    from vvenc_tpu_torch.ops.tables import device_tables
    oP = old_module("ops.intra_plan")
    k = P.PLAN_K
    rec = {"plan_trial_refs": {}, "plan_trial": {}, "public": {}}

    def close(a, b):
        rel = ((a[1] - b[1]).abs() / b[1].abs().clamp_min(1e-30)).max()
        return torch.equal(a[0], b[0]) and rel.item() <= COST_RTOL

    def outputs(B):
        return {v: (torch.empty((B, k), dtype=torch.int32, device=dev),
                    torch.empty((B, k), dtype=torch.float32, device=dev))
                for v in ("old", "new")}
    for tag, label, srcs, bd, qp, lmbda, sizes, reps, _ in plan_shapes():
        for s in sizes:
            blocks, tops, lefts, lm, ls = class_batch(torch, dev, srcs, s,
                                                      lmbda)
            B = blocks.shape[0]
            satd = S.presel_costs(blocks, tops, lefts, s, s, bd)
            outs = outputs(B)
            argv = {v: P.refs_launch_args(blocks, tops, lefts, satd, lm, ls,
                                          *outs[v], s, s, qp, bd, True, k)
                    for v in outs}
            new_call = (lambda: P.plan_trial_refs(
                blocks, tops, lefts, satd, lm, ls, s, s, qp, bd, True, k))
            r = old_new_case(
                torch, f"K3 plan_trial_refs ({label}, {s}x{s})",
                kernel_pair(okern, "plan_trial", "vt_plan_trial_refs",
                            P._K3R_ARGS, lambda v: argv[v]), outs,
                new_call, plan_bound_ms(B, s, k, "plan_trial_refs")[0],
                20, turn=reps, cold=True, same=close, B=B)
            for key in ("device_ms", "cold_device_ms"):
                new, old = r[key], r[f"old_{key}"]
                if new is not None and old is not None and \
                        new > old * (1 + K3_NOISE):
                    fail(f"K3 plan_trial_refs ({label}, {s}x{s}): {key} "
                         f"{new:.4f} ms against the parent's {old:.4f}")
            rec["plan_trial_refs"][f"{tag} {s}x{s}"] = r
            if tag.startswith("config1"):
                old_call = (lambda: oP.plan_trial_refs(
                    blocks, tops, lefts, satd, lm, ls, s, s, qp, bd, True,
                    k))
                rounds = [in_turns(torch, old_call, new_call, 200)
                          for _ in range(3)]
                rec["public"][f"plan_trial_refs {tag} {s}x{s}"] = {
                    "old_ms": [x[0] for x in rounds],
                    "ms": [x[1] for x in rounds]}
            # the preds form on K1's predictions
            preds = S.predict_all_modes(tops, lefts, s, s, bd)
            sk = S.satd_batch(blocks, preds, s, s)
            t = device_tables(s, s, dev)
            p = P._trial_params(s, s, qp, bd, True)
            tw, th = t["tr"][(s, p["trh"])], t["tr"][(s, p["trv"])]
            outs2 = outputs(B)
            argv2 = {v: (
                blocks.data_ptr(), preds.data_ptr(), sk.data_ptr(),
                lm.data_ptr(), ls.data_ptr(), t["mode_bits"].data_ptr(),
                tw.data_ptr(), th.data_ptr(), outs2[v][0].data_ptr(),
                outs2[v][1].data_ptr(), B, 67, s, s, k, p["shift1"],
                p["shift2"], p["ishift2"], p["qbits"], p["qscale"],
                p["qadd"], p["dshift"], p["dscale"], p["maxval"], P.RATE_C0,
                P.RATE_C1, P.RATE_C2, kernels.stream_ptr(outs2[v][1]))
                for v in outs2}
            rec["plan_trial"][f"{tag} {s}x{s}"] = old_new_case(
                torch, f"K3 plan_trial ({label}, {s}x{s})",
                kernel_pair(okern, "plan_trial", "vt_plan_trial",
                            P._K3_ARGS, lambda v: argv2[v]), outs2,
                lambda: P.plan_trial(blocks, preds, sk, lm, ls, s, s, qp, bd,
                                     True, k),
                plan_bound_ms(B, s, k)[0], 20, turn=reps, cold=True,
                same=close, B=B)
            del preds
    return rec


def print_old_new_k3(cmp: dict) -> None:
    """Per plan shape, the class sums of old_new_k3's records, old ->
    new (call, device warm and cold), then the per-class lines."""
    for n in ("plan_trial_refs", "plan_trial"):
        shapes = dict.fromkeys(t.rsplit(" ", 1)[0] for t in cmp[n])
        for shape in shapes:
            rs = [r for t, r in cmp[n].items()
                  if t.rsplit(" ", 1)[0] == shape]
            print(f"  {n} {shape}, {len(rs)} classes: call "
                  f"{sum(r['old_ms'] for r in rs):.4f} -> "
                  f"{sum(r['ms'] for r in rs):.4f} ms, device "
                  f"{dev_str(dev_sum(r['old_device_ms'] for r in rs))} -> "
                  f"{dev_str(dev_sum(r['device_ms'] for r in rs))}, cold "
                  f"{dev_str(dev_sum(r['old_cold_device_ms'] for r in rs))}"
                  f" -> {dev_str(dev_sum(r['cold_device_ms'] for r in rs))}"
                  f"; public {sum(r['public_ms'] for r in rs):.4f}; bound "
                  f"{sum(r['bound_ms'] for r in rs):.5f}", flush=True)
    print_old_new(cmp, ("plan_trial_refs", "plan_trial"))
    print_public(cmp, 200)


def k3_k4_phase(torch, dev, report):
    """Phase 3's planning kernels (the fused route beside K1 -> K2 ->
    K3; 1080p at 8 and 10 bits, config 1's plan batch and one of its
    pictures; build_plans through both routes) and K4 (both entries, a
    1080p 10-bit picture and an 832x480 8-bit crop) against their plain
    versions, timed per class, with the resources of K3's and K4's
    kernels per class."""
    from vvenc_tpu_torch.ops import intra_plan as P
    k = P.PLAN_K
    W, H = 1920, 1080

    def report_run(what, recs, runs, sizes, W, H, lmbdas):
        """Plan tables of the route and of K1 -> K2 -> K3 against the
        plain versions' (flips counted, only at near-ties), then the
        per-class lines and the class sums."""
        flips = compare_plans(sizes, W, H, lmbdas, runs["route"],
                              runs["plain"])
        old_flips = compare_plans(sizes, W, H, lmbdas, runs["old"],
                                  runs["plain"])
        ms = class_sums(recs)
        bounds = class_sums(recs, "bound_ms")
        print(f"phase 3: {what}: the fused SATD (presel_costs) bit-exact "
              f"to K2(K1(...)) and K1/K2 to their plain versions; K3 "
              f"plan_trial_refs and plan_trial modes equal to the plain "
              f"version's, costs max rel err "
              f"{max(r['plan_trial_refs_max_rel_err'] for r in recs):.3g} "
              f"and {max(r['plan_trial_max_rel_err'] for r in recs):.3g}; "
              f"plan tables equal with {flips} near-tie flips (K1 -> K2 -> "
              f"K3: {old_flips}); class sums: planning SATD "
              f"{ms['presel_costs_gathered']:.4f} ms (bound "
              f"{bounds['presel_costs_gathered']:.4f}) against K1 + K2 "
              f"{ms['intra_pred_all'] + ms['satd_modes']:.4f} (bounds "
              f"{bounds['intra_pred_all']:.4f} + "
              f"{bounds['satd_modes']:.4f}); K3 plan_trial_refs "
              f"{ms['plan_trial_refs']:.4f} (bound "
              f"{bounds['plan_trial_refs']:.4f}) against plan_trial "
              f"{ms['plan_trial']:.4f} (bound {bounds['plan_trial']:.4f}, "
              f"int32 yardstick "
              f"{sum(r['k3_int32_bound_ms'] for r in recs):.4f}); route "
              f"{ms['presel_costs_gathered'] + ms['plan_trial_refs']:.4f} "
              f"ms against K1 -> K2 -> K3 "
              f"{sum(ms[n] for n in OLD_PLAN_KERNELS):.4f}", flush=True)
        print_classes(recs)
        return flips, old_flips

    # phase 3: kernels against plain versions at 1080p, 8 and 10 bits,
    # then at the main path's shape: config 1's frame-parallel all-intra
    # encode plans its 10 frames in one batch, a streaming encode
    # (VVEncImpl) one picture at a time
    report["phase3"] = []
    for tag, label, srcs, bd, qp, lmbda, csizes, reps, plain_reps in \
            plan_shapes():
        fh, fw = srcs[0].shape
        recs, runs = run_classes(
            torch, dev, srcs, bd, qp, lmbda, csizes, True, k, reps=reps,
            plain_reps=plain_reps, check=True)
        flips, old_flips = report_run(label, recs, runs, csizes, fw, fh,
                                      [lmbda] * len(srcs))
        if tag.startswith("1080p"):
            report["phase3"].append({"bit_depth": bd, "flips": flips,
                                     "old_flips": old_flips,
                                     "classes": recs})
        else:
            report[tag] = {"flips": flips, "old_flips": old_flips,
                           "classes": recs}
    crecs = report["config1_batch"]["classes"]
    build_plans_phase(torch, dev, report)

    # phase 3, K4: one 1080p 10-bit picture, every MTT class (the medium
    # all-intra path's shape), and an 832x480 8-bit crop
    pic10 = luma_frames(W, H, 1, 10, seed=31)[0]
    precs, ppic = run_presel(torch, dev, pic10, 10, reps=3, plain_reps=1)
    run_presel(torch, dev, luma_frames(W, H, 1, 8, seed=32)[0][:480, :832],
               8, reps=0, plain_reps=0)
    pms = sum(r["ms"] for r in precs)
    pbound, pby = bound_ms(sum(r["work"][0] for r in precs),
                           sum(r["work"][1] for r in precs))
    gms = sum(r["gathered_ms"] for r in precs)
    gbound, gby = bound_ms(sum(r["gathered_work"][0] for r in precs),
                           sum(r["gathered_work"][1] for r in precs))
    print(f"phase 3: K4 presel_costs bit-exact on {len(precs)} MTT classes "
          f"({W}x{H} 10-bit, {ppic['B']} candidates) and on an 832x480 "
          f"8-bit crop, the gathered entry too; gathered per picture "
          f"{gms:.3f} ms (bound {gbound:.3f} ms, {gby}); plane form per "
          f"picture {pms:.3f} ms summed over classes, "
          f"{ppic['launch_ms']:.3f} ms launched back to back (device "
          f"{dev_str(ppic['device_ms'])}, cold "
          f"{dev_str(ppic['cold_device_ms'])}), bound "
          f"{pbound:.3f} ms ({pby}), plain "
          f"{sum(r['plain_ms'] for r in precs):.3f} ms; fetch of "
          f"{ppic['cost_bytes'] / 1e6:.1f} MB {ppic['fetch_ms']:.3f} ms "
          f"pinned ({ppic['fetch_pageable_ms']:.3f} ms pageable); "
          f"FramePresel (upload, launches, fetch) "
          f"{ppic['frame_presel_ms']:.3f} ms", flush=True)
    for r in precs:
        print(f"  class {r['w']:2d}x{r['h']:<2d} B={r['B']:6d}: "
              f"{r['ms']:.3f} ms (gathered {r['gathered_ms']:.3f}, plain "
              f"{r['plain_ms']:.3f}, bound {bound_ms(*r['work'])[0]:.3f})")
    report["presel"] = {"classes": precs, "picture": ppic}

    report["resources"] = print_resources()
    return pic10, crecs, precs, (pms, pbound, pby), (gms, gbound, gby)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", dest="json_path", default=None,
                    help="also write the detailed numbers to this file")
    ap.add_argument("--old-csrc", default=None,
                    help="the vvenc_tpu_torch/csrc directory of an older "
                         "checkout: also import that package, build its "
                         "K1-K3 and K5-K11 sources and "
                         "set them against the current ones (outputs equal, "
                         "times in turns, resources)")
    args = ap.parse_args(argv)
    json_path = args.json_path
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    # phase 1
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # phase 2: kernels (parallel nvcc) and the native library (g++)
    from vvenc_tpu_torch.ops import kernels
    t0 = t_run = time.time()
    built = {}
    old = {}
    th = threading.Thread(target=lambda: built.update(kernels.build()))
    th.start()
    if args.old_csrc:
        th_old = threading.Thread(target=lambda: old.update(
            zip(("kernels", "built"), old_package(args.old_csrc))))
        th_old.start()
    from vvenc_tpu_torch import capi_c, native
    capi_c.build()
    th.join()
    if args.old_csrc:
        th_old.join()
        if "kernels" not in old or not all(
                old["kernels"].so_path(n).exists() for n in OLD_SOURCES):
            fail(f"the old kernels of {args.old_csrc} did not build")
    t_build = time.time() - t0
    if not native.available():
        fail("the native library (native/entropy.cpp) did not build:\n"
             f"{native.BUILD_ERROR}")
    missing = [n for n in kernels.SOURCES if not kernels.so_path(n).exists()]
    if missing:
        fail(f"kernels not built: {missing}")
    print(f"phase 2: built {len(kernels.SOURCES)} kernel sources, the "
          f"native library and the C shim in {t_build:.1f} s", flush=True)
    print_ptxas(built)
    print_ptxas({f"{n} (old)": log
                 for n, log in old.get("built", {}).items()})

    report = {"card": card, "kind": kind, "build_seconds": t_build}
    pic10, crecs, precs, (pms, pbound, pby), (gms, gbound, gby) = \
        k3_k4_phase(torch, dev, report)
    stamp(t_run, "planning and K4")
    W, H = 1920, 1080

    # phase 3, K1 and K2: search_step's shape, the 1080p classes, config
    # 1's plan batch
    k12c = k12_cases(torch, dev, pic10)
    k12 = run_k12(torch, dev, k12c, reps=20, plain_reps=20)
    print("phase 3: K1 intra_pred_all and K2 satd_modes bit-exact against "
          "their plain versions at search_step's shape, the 1080p classes "
          "and config 1's plan batch (10-bit); the public call's ms (the "
          "kernel's device time of one call; bound):", flush=True)
    for tag, rr in k12.items():
        print(f"  {tag} B={rr['intra_pred_all']['B']}: " + ", ".join(
            f"{n} {r['ms']:.4f} ms (device {dev_str(r['device_ms'])}; "
            f"bound {bound_ms(*r['work'])[0]:.5f} {bound_ms(*r['work'])[1]})"
            for n, r in rr.items()), flush=True)
    for n in ("intra_pred_all", "satd_modes"):
        recs = [rr[n] for tag, rr in k12.items()
                if tag.startswith("config1 batch")]
        print(f"  config 1's plan batch, {n}: {sum(r['ms'] for r in recs):.4f}"
              f" ms over {len(recs)} classes (device "
              f"{dev_str(dev_sum(r['device_ms'] for r in recs))}; bound "
              f"{sum(bound_ms(*r['work'])[0] for r in recs):.4f})")
    report["k1_k2"] = k12
    ss = k12["search_step 16x16"]

    # phase 3, K5: two pictures at R = 64, 1080p (config 3's shape) and
    # 832x480 (config 2's), 8 and 10 bits; timed at 10 bits
    me, me_cases = {}, {}
    for (w, h), seed in (((W, H), 41), ((832, 480), 45)):
        pair = luma_frames(w, h, 2, 10, seed=seed)
        me[f"{w}x{h}"] = r = run_me(torch, dev, pair, 64, reps=20,
                                    plain_reps=3)
        run_me(torch, dev, luma_frames(w, h, 2, 8, seed=seed + 1), 64,
               reps=0, plain_reps=0)
        me_cases[f"{w}x{h}"] = me_planes(torch, dev, pair) + (64,)
        print(f"phase 3: K5 frame_me {w}x{h} R=64: MVs and costs equal at 8 "
              f"and 10 bits; {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
              f"bound {bound_ms(*r['work'])[0]:.4f})", flush=True)
    report["me"] = me
    stamp(t_run, "K1, K2 and K5")

    # phase 3, K6 and K7: residuals of 1080p pictures at 8 and 10 bits
    trecs = run_tr(torch, dev, {8: luma_frames(W, H, 1, 8, seed=71)[0],
                                10: pic10}, reps=20, plain_reps=3)
    print("phase 3: K6 fwd/inv_transform_batch and K7 quant/dequant_batch "
          f"bit-exact on {len(TR_CLASSES)} classes of {W}x{H} residuals, "
          "8 and 10 bits, QPs 22/37/51, both slice types; at 10 bits, QP "
          "37:", flush=True)
    for r in trecs:
        tag = "search_step" if r.get("search_step") else "class"
        print(f"  {tag} {r['w']:2d}x{r['h']:<2d} B={r['B']:6d}: " + ", ".join(
            f"{n} {r['ms'][n]:.4f} ms (device "
            f"{dev_str(r['device_ms'][n])}" + (
                f", cold {dev_str(r['cold_device_ms'][n])}"
                if "cold_device_ms" in r else "")
            + f", plain {r['plain_ms'][n]:.3f}, "
            f"bound {tr_bound(n, r)[0]:.5f}" + (
                f", int32 yardstick {bound_ms(*r['work'][n])[0]:.5f})"
                if n in K6_ENTRIES else ")")
            for n in TR_KERNELS if n in r["ms"]))
    report["transforms"] = trecs
    stamp(t_run, "K6 and K7")
    tr16 = next(r for r in trecs if (r["w"], r["h"]) == (16, 16)
                and not r.get("search_step"))
    trss = next(r for r in trecs if r.get("search_step"))

    # phase 3, K8-K11: their public functions at 1080p shapes
    pair8 = luma_frames(W, H, 2, 8, seed=81)
    small = {bd: luma_frames(416, 240, 1, bd, seed=91)[0] for bd in (8, 10)}
    mi10, ref_secs = mode_grid_inputs(torch, dev, pic10, small[10])
    batch, batch_fs_cases, batch_x = run_batch_ops(
        torch, dev, kernels,
        {10: (pic10, luma_frames(W, H, 2, 10, seed=31)[1]),
         8: tuple(pair8)}, small, mi10, ref_secs, reps=20, plain_reps=2)
    print(f"phase 3: K8 mc_batch ({len(LUMA_PHASES)} luma phases on "
          f"{batch['B']} 16x16 blocks, {len(CHROMA_PHASES)} chroma phases "
          "on 8x8 blocks of 960x540), K9 full_search_sse (16x16, R=16: "
          "integer SSEs and argmins equal), K10 sse/sad/satd ([B,16,16] "
          "satd tiles 4/8/16, [480,64,64] tiles 4/8/64) and K11 "
          "mode_costs (1080p 16x16 and 32x32, 416x240 4x4/8x8/64x64; 8-bit on 416x240 4..64) "
          "bit-exact against their plain versions at 8 and 10 bits; "
          "build_ref_mains (host) " + ", ".join(
              f"{k} {v:.2f} s" for k, v in
              batch["build_ref_mains_s"].items()), flush=True)
    for n in BATCH_KERNELS:
        bms, by = batch_bound(n, batch)
        print(f"  {n}: {batch['ms'][n]:.4f} ms (kernel alone "
              f"{dev_str(batch['device_ms'][n])}, plain "
              f"{batch['plain_ms'][n]:.3f}, bound {bms:.4f} {by}" + (
                  f"; int32 yardstick {bound_ms(*batch['work'][n])[0]:.4f})"
                  if n == "full_search_sse" else ")"))
    for fs, fr in FS_SHAPES:
        r = batch["per_call"][f"full_search {fs}x{fs} R={fr}"]
        fsb = fs_bound_ms(r["B"], fs, fs, fr)[0]
        print(f"  full_search {fs}x{fs} R={fr} B={r['B']}: {r['ms']:.4f} ms "
              f"(device {dev_str(r['device_ms'])}, plain "
              f"{r['plain_ms']:.3f}, bound {fsb:.4f}; int32 yardstick "
              f"{bound_ms(*r['work'])[0]:.4f})")
    for tag, _ in MODE_SIZES:
        r = batch["per_call"][f"mode_costs {tag}"]
        print(f"  mode_costs {tag} B={r['B']}: {r['ms']:.4f} ms (bound "
              f"{bound_ms(*r['work'])[0]:.4f})")
    for k, r in batch["per_call"].items():
        if " kind " in k or k.startswith(("satd_batch ", "sse_batch ",
                                          "sad_batch ")):
            bms, by = bound_ms(*r["work"])
            print(f"  {k} B={r['B']}: {r['ms']:.4f} ms (device "
                  f"{dev_str(r['device_ms'])}, cold "
                  f"{dev_str(r['cold_device_ms'])}; bound {bms:.5f} {by})")
    lp = batch["per_call"]["mc_batch luma phases device_ms"]
    mean = dev_sum(lp)
    print("  mc_batch luma 16x16, device ms of the 16 phases "
          f"{LUMA_PHASES}: " + ", ".join(dev_str(v) for v in lp)
          + f"; mean {dev_str(None if mean is None else mean / len(lp))}")
    report["batch_ops"] = batch
    stamp(t_run, "K8-K11")
    if old:
        okern = old["kernels"]
        fs_cases = {f"{s}x{s} R={R}": (s, s, R) + batch_fs_cases[(s, R)]
                    for s, R in FS_SHAPES}
        fs_cases.update(fs_int_cases(torch, dev, pic10))
        k6c = tr_cases(torch, dev, pic10)
        cmp = old_new_phase(torch, dev, okern, me_cases, mi10, k6c, fs_cases,
                            reps=20)
        print(f"phase 3: K1, K2, K5, K6, K9 and K11 against the kernels of "
              f"{args.old_csrc}: "
              "outputs equal; old -> new ms, called alike and timed old, "
              "new, new, old (device time of a call alone; the public "
              "function; bound)", flush=True)
        cmp.update(old_new_k12(torch, dev, okern, k12c, reps=20))
        print_old_new(cmp, ("frame_me", "mode_costs") + K6_ENTRIES + (
            "full_search_sse", "intra_pred_all", "satd_modes"))
        for n in ("intra_pred_all", "satd_modes"):
            rs = [r for tag, r in cmp[n].items()
                  if tag.startswith("config1 batch")]
            print(f"  {n} config 1's plan batch ({len(rs)} classes): "
                  f"{sum(r['old_ms'] for r in rs):.4f} -> "
                  f"{sum(r['ms'] for r in rs):.4f} ms (device "
                  f"{dev_str(dev_sum(r['old_device_ms'] for r in rs))} -> "
                  f"{dev_str(dev_sum(r['device_ms'] for r in rs))}; bound "
                  f"{sum(r['bound_ms'] for r in rs):.5f})")
        k810 = old_new_k8k10(torch, dev, okern, batch_x[10], batch_x[8],
                             reps=20)
        print("phase 3: K8 mc_batch and K10 satd_batch against the kernels "
              f"of {args.old_csrc}: outputs equal at every phase and tile, "
              "8 and 10 bits; old -> new ms at 10 bits, called alike and "
              "timed old, new, new, old (device time of the kernel alone; "
              "cold: after an L2 flush; the public function; bound)",
              flush=True)
        print_old_new(k810, ("mc_batch", "satd_batch"))
        print_public(k810)
        cmp.update(k810)
        k710 = old_new_k7k10(torch, dev, okern, batch_x[10], batch_x[8], k6c,
                             reps=20)
        print("phase 3: K7 quant/dequant_batch and K10 sse/sad_batch "
              f"against the kernels of {args.old_csrc}: outputs equal (K10 "
              "on the 4x4, 8x8, 16x16 and 64x64 grids at 8 and 10 bits, K7 "
              "on every class at 10 bits, QP 37); old -> new ms at 10 bits, "
              "called alike and timed old, new, new, old (device time of "
              "the kernel alone; cold: after an L2 flush; the public "
              "function; bound)", flush=True)
        print_old_new(k710, ("quant_batch", "dequant_batch", "sse_batch",
                             "sad_batch"))
        print_public(k710)
        for n in ("quant_batch", "dequant_batch", "sse_batch", "sad_batch"):
            cmp[n] = k710[n]
        cmp["public"].update(k710["public"])
        k3 = old_new_k3(torch, dev, okern)
        print("phase 3: K3 plan_trial_refs and plan_trial against the "
              f"kernels of {args.old_csrc}: the reference entry's modes "
              f"equal and costs within {COST_RTOL}, the preds form's "
              "too, on every class of the 1080p x4 batches (8 "
              "and 10 bits), config 1's plan batch and one of its "
              "pictures; the reference entry's device time, warm and "
              f"cold, within {K3_NOISE:.0%} of the old one's or better in "
              "every class; old -> new ms, called alike and timed old, new, "
              "new, old (device time of the kernel alone; cold: after an "
              "L2 flush; the public function; bound)", flush=True)
        print_old_new_k3(k3)
        for n in ("plan_trial_refs", "plan_trial"):
            cmp[n] = k3[n]
        cmp["public"].update(k3["public"])
        for label, r in cmp["resources"].items():
            print(resource_line(f"{label} (old)", r))
        report["old_new"] = cmp
        stamp(t_run, "the old/new comparison")

    # phase 4: the main paths through the CLI
    from vvenc_tpu_torch.tools.calibrate_plan import make_clip
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    clip1 = os.path.join(tmp, "c1.yuv")
    make_clip(clip1, 416, 240, 10)
    _, report["config1"] = encode_phase(
        torch, kernels, "config1", clip1, 416, 240, 10, 37, "faster",
        ["--intra-period", "1"], PLAN_KERNELS, plan=True)
    clip_hd = os.path.join(tmp, "hd.yuv")
    make_clip(clip_hd, 1920, 1080, 4)
    _, report["hd"] = encode_phase(
        torch, kernels, "hd_faster", clip_hd, 1920, 1080, 4, 37,
        "faster", ["--intra-period", "1"], PLAN_KERNELS, plan=True)
    if old:
        old_k3_streams(torch, kernels, {
            "config1": (clip1, 416, 240, 10),
            "hd_faster": (clip_hd, 1920, 1080, 4)})
    enc, report["hd_medium"] = encode_phase(
        torch, kernels, "hd_medium", clip_hd, 1920, 1080, 2, 37,
        "medium", ["--intra-period", "1"], ("presel_costs",))
    if enc.cfg.intra_presel != "source":
        fail(f"hd_medium: intra_presel resolved to {enc.cfg.intra_presel!r}")
    clip2 = os.path.join(tmp, "c2.yuv")
    make_clip(clip2, 832, 480, 17)
    _, report["config2"] = encode_phase(
        torch, kernels, "config2", clip2, 832, 480, 17, 37, "faster",
        ["--gop-size", "8", "--intra-period", "0", "--set",
         "me_mode=device"], ("frame_me",))
    # config 3 cut from 9 to 3 frames (the IDR and one GOP of 2) to keep
    # the run near its time
    clip3 = os.path.join(tmp, "c3.yuv")
    make_clip(clip3, 1920, 1080, 3)
    _, report["config3"] = encode_phase(
        torch, kernels, "config3", clip3, 1920, 1080, 3, 32,
        "medium", ["--gop-size", "2", "--intra-period", "0", "--qpa", "1",
                   "--wpp", "--threads", "2", "--set", "me_mode=device"],
        ("frame_me",))
    stamp(t_run, "the CLI encodes")
    report["tools"] = tools_phase(clip1, 416, 240, 10, tmp)
    stamp(t_run, "the tool twins")
    report["bench_twin"] = bench_twin_phase(clip1, tmp)
    stamp(t_run, "the bench twin")
    clips = {"config1": (clip1, 416, 240, 10, "faster", True),
             "hd_faster": (clip_hd, 1920, 1080, 4, "faster", True),
             "hd_medium": (clip_hd, 1920, 1080, 2, "medium", False),
             "config2": (clip2,)}
    api_launches = api_phase(torch, kernels, clips, tmp, report)
    del clips["config2"]
    stamp(t_run, "the library entry points")
    mesh_launches = mesh_phase(torch, dev, kernels, clips, pic10,
                               report)
    stamp(t_run, "the mesh path")

    # phase 5: one line per kernel entry; launches from the path run
    # that reaches it (K3's reference entry VVEncImpl streaming config 1,
    # where the preds-form K3 shows its 0; K1 and K2, which no encode path
    # launches, dryrun_multichip(4) through search_step; K4 the 1080p
    # medium all-intra encode, K5 VVEncImpl streaming config 2, K4's
    # gathered entry that encode with intra_presel.MESH set, K6 and K7
    # dryrun_multichip(4), K8-K11 the full-width calls of their public
    # functions); each time is at the shape its launches run: K1, K2 and
    # K6 search_step's, both K3 entries config 1's plan batch, K5 832x480
    # (phase 3 prints K1/K2 on the plan batch, K5 at 1080p and K6 on the
    # 1080p classes beside)
    entries = []
    for n, (src, replaces) in KERNELS.items():
        if n in BATCH_KERNELS:
            ms, plain_ms, err = batch["ms"][n], batch["plain_ms"][n], 0.0
            bms, by = batch_bound(n, batch)
            path = "dist_batch" if n in ("sse_batch", "sad_batch",
                                         "satd_batch") else n
            nl = batch["launches"][path][n]
        elif n in ("intra_pred_all", "satd_modes"):
            # search_step's shape, where dryrun_multichip(4) launches them
            r = ss[n]
            ms, plain_ms, err = r["ms"], r["plain_ms"], 0.0
            bms, by = bound_ms(*r["work"])
            nl = mesh_launches["dryrun"][n]
        elif n in ("plan_trial", "plan_trial_refs"):
            ms = sum(r["ms"][n] for r in crecs)
            plain_ms = sum(r["plain_ms"][n] for r in crecs)
            # per class (K3's as the kernel computes it, plan_bound_ms)
            bms = sum(r["bound_ms"][n] for r in crecs)
            by = max(("bytes", "operations"), key=lambda b: sum(
                r["bound_ms"][n] for r in crecs if r["bound_by"][n] == b))
            err = max(r[f"{n}_max_abs_err"] for r in crecs)
            nl = api_launches["api_config1"][n]
        elif n == "presel_costs":
            ms, plain_ms, bms, by, err = pms, sum(
                r["plain_ms"] for r in precs), pbound, pby, 0.0
            nl = report["hd_medium"]["launches"][n]
        elif n == "presel_costs_gathered":
            ms, plain_ms, bms, by, err = gms, sum(
                r["plain_ms"] for r in precs), gbound, gby, 0.0
            nl = mesh_launches["encodes"]["hd_medium"][n]
        elif n in TR_KERNELS:
            # K6 at search_step's shape, where dryrun_multichip(4)
            # launches it (phase 3 prints the 1080p classes beside); K7
            # the 1080p 16x16 grid (B = 8,040) at 10 bits, QP 37
            r = trss if n in K6_ENTRIES else tr16
            ms, plain_ms, err = r["ms"][n], r["plain_ms"][n], 0.0
            bms, by = tr_bound(n, r)
            nl = mesh_launches["dryrun"][n]
        else:
            # config 2's 832x480, where VVEncImpl streaming launches it
            r = me["832x480"]
            ms, plain_ms, err = r["ms"], r["plain_ms"], r["max_abs_err"]
            bms, by = bound_ms(*r["work"])
            nl = api_launches["api_config2"][n]
        entries.append({"name": n, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": nl,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": None})
    report["kernels"] = entries
    write_json(json_path, report)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
