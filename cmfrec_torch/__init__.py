"""cmfrec_torch — collective matrix factorization in PyTorch, for NVIDIA Hopper.

The port of cmfrec_tpu (the JAX package beside it, which stays the
reference).  Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels for sm_90a (csrc/), each with a plain torch twin
that runs on CPU tensors.  The package never imports JAX.

So far: the explicit ``CMF`` fit (dense-masked engine, or the bucketed
sparse engine for data whose dense form does not fit), with dense side
information and implicit features on the dense-masked engine; the implicit
``CMF_implicit`` fit (dense-masked engine when a card holds the dense form,
else bucketed), with dense side information on the dense-masked engine;
plus predict/topN/save/load; warm and cold serving of both
(factors_warm/cold, factors_multiple, transform, predict_new, topN_*) on
the model's device; and ``CMF_imputer``.  See ROADMAP.md for what follows.
"""

from .models.cmf import CMF, CMF_implicit
from .models.imputer import CMF_imputer

__all__ = ["CMF", "CMF_implicit", "CMF_imputer"]

__version__ = "0.1.0"
