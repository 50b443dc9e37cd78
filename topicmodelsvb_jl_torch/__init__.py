"""topicmodelsvb_jl_torch — variational-Bayes topic modeling in PyTorch.

The PyTorch and CUDA port of ``topicmodelsvb_jl_tpu`` for one NVIDIA
Hopper GPU (or the CPU).  It covers the main paths of LDA, fLDA, CTPF,
CTM and fCTM: a packed, length-bucketed corpus, batch-synchronous CAVI
with hand-written CUDA kernels for the E-steps of LDA, fLDA and CTPF, the
ELBO token terms of LDA and CTM and every family's M-step scatter, and
plain PyTorch versions of each kernel for CPU tensors.  It imports no JAX.
"""

from .api import CTM, CTPF, LDA, fCTM, fLDA
from .corpus import Corpus, CorpusError, Document, DocumentError
from .datasets import synth_corpus, synth_packed_nsf_scale
from .ops.packing import PackedCorpus, bucketize_packed, pack_corpus
from .utils.config import RuntimeConfig, TrainConfig

__all__ = [
    "LDA", "fLDA", "CTM", "fCTM", "CTPF", "Corpus", "Document", "CorpusError",
    "DocumentError", "TrainConfig",
    "RuntimeConfig",
    "PackedCorpus", "bucketize_packed", "pack_corpus", "synth_corpus",
    "synth_packed_nsf_scale",
]
