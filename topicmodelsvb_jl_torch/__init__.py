"""topicmodelsvb_jl_torch — variational-Bayes topic modeling in PyTorch.

The PyTorch and CUDA port of ``topicmodelsvb_jl_tpu`` for one NVIDIA
Hopper GPU (or the CPU).  This slice covers LDA's main path: a packed,
length-bucketed corpus, batch-synchronous CAVI with hand-written CUDA
kernels for the E-step and the ELBO's token terms, and plain PyTorch
versions of both for CPU tensors.  It imports no JAX.
"""

from .api import LDA
from .datasets import synth_packed_nsf_scale
from .ops.packing import PackedCorpus, bucketize_packed
from .utils.config import RuntimeConfig, TrainConfig

__all__ = [
    "LDA", "TrainConfig", "RuntimeConfig", "PackedCorpus",
    "bucketize_packed", "synth_packed_nsf_scale",
]
