"""The least time of device planning's work on the card.

The function is one QT size class of _plan_class_core, K4's gathered
entry then K3's reference entry: for each candidate s x s block, the 67
intra predictions from its reference samples, the Hadamard SATD of each,
top-k by SATD plus mode bits, and a transform / quantisation trial of
each of the k survivors.  The count is of that function's work, not of
the form a kernel computes it in, so no route can read over 100 %:

  bytes  each input read once and each output written once, as the
         function takes and returns them: the block (int32), its top and
         left references (2 x (2s + 3) int32), its λ and λ_sad (float32);
         k modes (int32) and k costs (float32)
  ops    at the float32 peak: prediction, 7 a sample of each of the 60
         fractional-angle modes (a 4-tap filter), 8 of planar, none of DC
         and of the five whole-sample angles; SATD, a difference, the
         two Hadamard stages (log2 t adds each, t = 8, or 4 for 4-wide
         blocks), an absolute value and a sum; then 17 a sample of each
         survivor's trial outside its transforms (residual 1,
         quantisation 4, dequantisation 3, reconstruction 3, SSE 3, the
         rate proxy's count and log2 3)
         at the int8 tensor-core peak: the transforms' products, which
         an exact split-int8 route carries: per survivor forward and
         inverse, two s-point stages each, 2 s multiply-adds a sample
         a stage

The least time is the larger of bytes / bandwidth and the sum of each
class of operations over its peak; least_seconds says which bound wins.
"""

import math

KERNELS = ("presel_costs_kernel", "plan_square_small_kernel",
           "plan_refs_tc_kernel")
FRACTIONAL_ANGLES = 60      # 65 angular modes less 2, 18, 34, 50, 66
NUM_MODES = 67


def is_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def block_work(s: int, k: int):
    """(bytes, float32-pipe ops, int8 tensor-core ops) of one s x s
    candidate."""
    n = s * s
    nbytes = 4 * n + 2 * 4 * (2 * s + 3) + 8 + k * 8
    t = 8 if s % 8 == 0 else 4
    pred = (FRACTIONAL_ANGLES * 7 + 8) * n
    satd = NUM_MODES * (1 + 2 * int(math.log2(t)) + 2) * n
    select = 2 * NUM_MODES
    trial = k * 17 * n
    tc = k * 2 * 2 * (2 * s) * n      # fwd + inv, 2 stages, s MACs
    return nbytes, pred + satd + select + trial, tc


def least_seconds(work: dict, peaks: dict):
    """(seconds, "bytes" or "operations") for work {(s, k, bit_depth):
    candidate blocks}."""
    b = f = q = 0
    for (s, k, _bd), blocks in work.items():
        nb, nf, nq = block_work(s, k)
        b += blocks * nb
        f += blocks * nf
        q += blocks * nq
    t_bytes = b / peaks["hbm_bytes_per_s"]
    t_ops = f / peaks["f32_ops_per_s"] + q / peaks["int8_tensor_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
