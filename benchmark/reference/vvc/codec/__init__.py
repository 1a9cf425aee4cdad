"""Codec core: picture/CU state model shared by encoder and subset decoder.

The numpy "spec model" layer (the analog of vvenc's CommonLib scalar paths,
SURVEY.md §2.3): QP derivation, partitioning, CU syntax, reconstruction.
The encoder uses these for final bitstream emission while its device RD
planning runs as CUDA kernels (ops/intra_presel.py, ops/intra_plan.py).
"""
