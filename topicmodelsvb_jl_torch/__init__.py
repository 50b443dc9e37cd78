"""topicmodelsvb_jl_torch — variational-Bayes topic modeling in PyTorch.

The PyTorch and CUDA port of ``topicmodelsvb_jl_tpu`` for one NVIDIA
Hopper GPU (or the CPU).  It covers the corpus pipeline (``readcorp``,
``fixcorp`` and its mutators), LDA, fLDA, CTPF, CTM and fCTM built from a
``Corpus`` or a packed corpus, and the post-hoc surface (``showtopics``,
``predict``, ``gencorp``, the CTPF displays, ``evaluate``).  Training is
batch-synchronous CAVI on a length-bucketed corpus, with hand-written CUDA
kernels for the E-steps of LDA, fLDA and CTPF, the ELBO token terms of LDA
and CTM and every family's M-step scatter, and plain PyTorch versions of
each kernel for CPU tensors.  It imports no JAX.
"""

from .corpus import (
    Corpus, CorpusError, Document, DocumentError,
    abridge_corp, alphabetize_corp, check_corp, check_doc, check_docs,
    compact_corp, condense_corp, expand_corp, fixcorp, getusers, getvocab,
    pad_corp, readcorp, remove_empty_docs, remove_redundant, remove_terms,
    showdocs, showtitles, stop_corp, trim_corp, trim_docs, writecorp,
)
from .datasets import (
    load_citeu, load_englishwords, load_mac, load_nsf, load_stopwords,
    synth_corpus, synth_packed_nsf_scale,
)
from .utils.config import RuntimeConfig, TrainConfig

from .api import (
    CTM, CTPF, LDA, TopicModel, TopicModelError, fCTM, fLDA, gencorp, gendoc, predict,
)
from .evaluate import (
    heldout_reader_rank, holdout_readers, perplexity, ranked_users, recall_at_k,
    topic_coherence,
)
from .ops.packing import PackedCorpus, bucketize_packed, pack_corpus
from .validate import check_model

__all__ = [
    "Corpus", "Document", "CorpusError", "DocumentError", "TopicModelError",
    "readcorp", "writecorp", "fixcorp", "check_corp", "check_doc",
    "showdocs", "showtitles", "getvocab", "getusers",
    "load_nsf", "load_citeu", "load_mac", "load_stopwords", "load_englishwords",
    "synth_corpus", "synth_packed_nsf_scale",
    "LDA", "fLDA", "CTM", "fCTM", "CTPF", "TopicModel",
    "predict", "gendoc", "gencorp",
    "perplexity", "topic_coherence", "holdout_readers",
    "heldout_reader_rank", "ranked_users", "recall_at_k",
    "check_model",
    "TrainConfig", "RuntimeConfig",
    "PackedCorpus", "bucketize_packed", "pack_corpus",
]
