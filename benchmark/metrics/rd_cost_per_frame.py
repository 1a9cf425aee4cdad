"""rd_cost_per_frame: the encoder's Lagrangian cost over the window's
pictures, SSE of the reconstruction against the input over Y, Cb and Cr
at the internal bit depth plus λ times the stream's bits, a picture.

λ is one number for the cell, vvenc's λ at the cell's QP for an intra
picture: dQPFactor 0.57 times 2^((QP - 12 + 6 (bitDepth - 8)) / 3)
(vvenc EncSlice's lambda derivation, SHIFT_QP = 12, distortion at the
internal bit depth).  It is computed here from the configuration and
never read from the port.  At a fixed QP the cost rises when a change
trades compression for speed; with a fixed seed it repeats exactly.
The harness computes the metric (harness.judge) from pictures that the
comparison judged.
"""


def lambda_for(cfg: dict) -> float:
    qp, bd = cfg["qp"], cfg["internal_bit_depth"]
    return 0.57 * 2.0 ** ((qp - 12 + 6 * (bd - 8)) / 3.0)
