"""Tools beside the port: twins of the repository's tools/bdrate.py and
tools/calibrate_plan.py that drive vvenc_tpu_torch (on the card unless
--device cpu is given) in place of the JAX package.

    python -m vvenc_tpu_torch.tools.bdrate --clip c.yuv --size 416x240 ...
    python -m vvenc_tpu_torch.tools.calibrate_plan [clip.yuv WxH frames]
"""
