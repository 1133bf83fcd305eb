"""PyTorch/CUDA port of the BSS-2 EXTOLL pulse-communication reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``snn/``, ``kernels/<name>/``, ``configs/``) and runs on an
NVIDIA GPU, with hand-written CUDA kernels for the fused inject, fused
drain and bucket-pack stages.  Entry points default to ``device="cuda"``.
"""
