"""A frozen copy of vvenc_tpu_torch's decoder and of the plain PyTorch
versions of its device-planning and motion-estimation functions, taken
at the port's fourteenth bring-up commit.

The benchmark judges the port's output with it: the decoder parses and
reconstructs the streams the port writes, ops.intra_plan's plain route
(predict_all_modes -> satd_batch -> plan_trial) recomputes the plans of
the port's planning kernels, and ops.me.frame_me_ref the motion vectors
of its ME kernel.  It imports nothing of the port: the CUDA kernel
loader (ops/kernels.py) and the native C++ library (native.py) are
stubs here, so every function takes its plain Python, NumPy or PyTorch
path on the CPU.
"""
