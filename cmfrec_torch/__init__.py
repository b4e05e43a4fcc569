"""cmfrec_torch — collective matrix factorization in PyTorch, for NVIDIA Hopper.

The port of cmfrec_tpu (the JAX package beside it, which stays the
reference).  Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels for sm_90a (csrc/), each with a plain torch twin
that runs on CPU tensors.  The package never imports JAX.

So far: the explicit ``CMF`` fit (dense-masked engine, or the bucketed
sparse engine for data whose dense form does not fit), with side
information and implicit features (dense side info on the dense-masked
engine, the rest on the bucketed collective route), and ``method="lbfgs"``,
the joint-objective L-BFGS fit that also takes binary side information
(``U_bin``, ``I_bin``); the implicit ``CMF_implicit`` fit; the offsets
models ``OMF_explicit`` (L-BFGS or ALS) and ``OMF_implicit`` (ALS), the
attribute-only ``ContentBased`` and the ``MostPopular`` baseline; plus
predict/topN/save/load (cmfrec_tpu's .npz format, both ways); warm and
cold serving of every model (factors_warm/cold, factors_multiple,
transform, predict_new, topN_*) on the model's device; and
``CMF_imputer``.  See ROADMAP.md for what follows.
"""

from .models.cmf import CMF, CMF_implicit
from .models.imputer import CMF_imputer
from .models.most_popular import MostPopular
from .models.omf import ContentBased, OMF_explicit, OMF_implicit

__all__ = ["CMF", "CMF_implicit", "CMF_imputer", "OMF_explicit",
           "OMF_implicit", "ContentBased", "MostPopular"]

__version__ = "0.1.0"
