"""sphexa_tpu_torch: the PyTorch/CUDA port of sphexa_tpu for one NVIDIA H100.

The JAX package `sphexa_tpu` is the reference; this package mirrors its
layout module by module and imports nothing of it. Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a hand-written CUDA
kernel under `csrc/`, with a plain PyTorch version beside its wrapper
(ops/pair_ve.py). Entry points run on the GPU unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"
