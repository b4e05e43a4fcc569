"""cmfrec_torch — collective matrix factorization in PyTorch, for NVIDIA Hopper.

The port of cmfrec_tpu (the JAX package beside it, which stays the
reference).  Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels for sm_90a (csrc/), each with a plain torch twin
that runs on CPU tensors.  The package never imports JAX.

This slice: the explicit ``CMF`` fit without side info on the dense-masked
engine, plus predict/topN/save/load.  See ROADMAP.md for what follows.
"""

from .models.cmf import CMF

__all__ = ["CMF"]

__version__ = "0.1.0"
