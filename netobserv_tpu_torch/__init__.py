"""PyTorch/CUDA port of the netobserv_tpu sketch plane.

The JAX package `netobserv_tpu` stays the reference. This package mirrors its
module paths, imports nothing of it, and runs on an NVIDIA card: the Pallas
kernels of the main path are hand-written CUDA kernels under `csrc/`, each
beside a plain PyTorch version that CPU tensors take.
"""
