"""PyTorch/CUDA port of the BSS-2 EXTOLL pulse-communication reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``snn/``, ``models/``, ``kernels/<name>/``, ``configs/``,
``launch/``) and runs on an NVIDIA GPU, with a hand-written CUDA kernel for
every Pallas kernel of the reference.  Entry points default to
``device="cuda"``.
"""
