"""magicpig_tpu_torch — the PyTorch and CUDA port of magicpig_tpu.

LSH-sampled long-context decoding (MagicPIG) for an NVIDIA H100: the same
engine API as the JAX package, with its TPU kernels rewritten by hand for
Hopper (`ops/kernels/`, sources in `csrc/`). The JAX package stays the
reference; this package imports none of it.
"""

__version__ = "0.1.0"
