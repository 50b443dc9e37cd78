"""End-to-end walkthrough of the PyTorch port, mirroring the reference
README's tutorials.

The same ten sections as ``examples/walkthrough.py``, through
``topicmodelsvb_jl_torch`` (the NSF/CiteULike docfiles are stripped from
the mirror, so the bundled loaders synthesize documents at published
scale against the real vocabularies; see datasets.py):

  1. corpus loading + fixcorp preprocessing        (README.md:150-210)
  2. LDA training, showtopics, topicdist           (README.md:211-313)
  3. generative round-trip: gencorp -> retrain     (README.md:315-350)
  4. held-out prediction with predict              (README.md:422-505)
  5. CTM correlated topics                         (README.md:352-420)
  6. CTPF recommendations, warm-started from LDA   (README.md:512-580, 669-674)
  7. checkpoint save/resume                        (no reference equivalent)
  8. perplexity, coherence, leave-one-reader-out   (README.md:512-560 protocol)
  9. beyond-memory streaming + one-pass online SVI (no reference equivalent)
 10. HMTM: the reference's unfinished model, working (HMTM/HMTMREADME.md)

Every model runs on ``WALKTHROUGH_DEVICE`` (default ``cuda``; without a
GPU the first model's constructor raises).  Each section ends with one
line giving its wall time and its last ELBO or figure; the times are also
left in ``SECTION_TIMES``.

Run: python examples/walkthrough_torch.py   (12-16 s on an NVIDIA H100
     80GB HBM3 at a 700 W power limit, as chip_smoke.py's phase 18 runs it)
     WALKTHROUGH_DEVICE=cpu python examples/walkthrough_torch.py  (with the
     small sizes of tests/test_torch_walkthrough.py for a laptop run)
"""

import os
import sys
import tempfile
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
warnings.filterwarnings("ignore")

import numpy as np

import topicmodelsvb_jl_torch as tm

DEVICE = os.environ.get("WALKTHROUGH_DEVICE", "cuda")
SUBSET = int(os.environ.get("WALKTHROUGH_DOCS", 3000))
# shrink knobs (tests/test_torch_walkthrough.py): every fixed size scales
# down so the whole story runs end to end in about a minute on the CPU
CITEU_DOCS = int(os.environ.get("WALKTHROUGH_CITEU_DOCS", 2000))
GEN_DOCS = int(os.environ.get("WALKTHROUGH_GEN_DOCS", 1000))
STREAM_DOCS = int(os.environ.get("WALKTHROUGH_STREAM_DOCS", 4096))
STREAM_BATCH = max(64, STREAM_DOCS // 4)
HMTM_DOCS = int(os.environ.get("WALKTHROUGH_HMTM_DOCS", 200))
CTPF_K = int(os.environ.get("WALKTHROUGH_CTPF_K", 30))

SECTION_TIMES = {}   # section number -> wall seconds
_open = []           # [number, start] of the section running


def section(n, title):
    _open[:] = [n, time.perf_counter()]
    print(f"\n{'=' * 60}\n{n}. {title}\n{'=' * 60}")


def done(figure):
    """Close the running section: its wall time and its last figure."""
    n, t0 = _open
    SECTION_TIMES[n] = time.perf_counter() - t0
    print(f"[section {n}] {SECTION_TIMES[n]:.3f} s; {figure}")


# ── 1. corpus + preprocessing (reference readcorp(:nsf) + fixcorp!) ──
section(1, "Corpus loading and preprocessing")
corp = tm.load_nsf(subset=SUBSET)
print("loaded:", corp)
tm.fixcorp(corp, stop=True, abridge=5, trim=True, alphabetize=True,
           remove_empty_docs=True)
print("fixed: ", corp)
done(f"{len(corp)} documents, {len(corp.vocab)} terms")

# ── 2. LDA (reference README.md:211-313, K=9, seed-controlled) ──
section(2, "LDA: train, showtopics, topicdist")
lda = tm.LDA(corp, 9, device=DEVICE, seed=7)
lda.train(iter=30, tol=0.0, checkelbo=10)
lda.showtopics(V=8, cols=3)
theta = lda.topicdist(1)
print("\ndoc 1 topic distribution:", np.round(theta, 3))
done(f"ELBO {lda.elbo:.1f}")

# ── 3. generative round-trip (reference README.md:315-350) ──
section(3, "gencorp round-trip: sample a corpus, retrain, recover topics")
synth = tm.gencorp(lda, M=GEN_DOCS, laplace_smooth=1e-6, seed=1)
lda2 = tm.LDA(synth, 9, device=DEVICE, seed=2)
lda2.train(iter=20, tol=0.0, checkelbo=np.inf, printelbo=False)
# greedy-match retrained topics to the originals by top-word overlap
b1 = np.asarray(lda.beta)
b2 = np.asarray(lda2.beta)
top1 = np.argsort(-b1, 1)[:, :20]
top2 = np.argsort(-b2, 1)[:, :20]
overlap = np.zeros((9, 9))
for i in range(9):
    for j in range(9):
        overlap[i, j] = len(set(top1[i]) & set(top2[j]))
print("best top-20-word overlap per original topic:",
      overlap.max(axis=1).astype(int), "/ 20")
done(f"mean top-20 overlap {overlap.max(axis=1).mean():.2f} / 20")

# ── 4. held-out prediction (reference README.md:422-505) ──
section(4, "predict on held-out documents")
train_docs, test_docs = corp.docs[:-50], corp.docs[-50:]
train_corp = tm.Corpus(docs=train_docs, vocab=corp.vocab, users=corp.users)
test_corp = tm.Corpus(docs=test_docs, vocab=corp.vocab, users=corp.users)
m = tm.LDA(train_corp, 9, device=DEVICE, seed=7)
m.train(iter=20, tol=0.0, checkelbo=np.inf, printelbo=False)
pred = tm.predict(test_corp, m)
print("held-out doc 1 topicdist:", np.round(pred.topicdist(1), 3))
done(f"held-out doc 1 top topic {int(np.argmax(pred.topicdist(1))) + 1}")

# ── 5. CTM (reference README.md:352-420) ──
section(5, "CTM: correlated topics")
ctm = tm.CTM(corp, 9, device=DEVICE, seed=7)
ctm.train(iter=15, tol=0.0, checkelbo=5)
sig = np.asarray(ctm.sigma)
corr = sig / np.sqrt(np.outer(np.diag(sig), np.diag(sig)))
i, j = divmod(int(np.argmax(corr - np.eye(9) * 2)), 9)
print(f"most correlated topic pair: ({i + 1}, {j + 1}) "
      f"corr={corr[i, j]:.3f}")
done(f"ELBO {ctm.elbo:.1f}")

# ── 6. CTPF recommender, warm-started (README.md:512-580, 669-674) ──
section(6, "CTPF: recommendations (warm-started from an LDA)")
citeu = tm.load_citeu(subset=CITEU_DOCS)
tm.fixcorp(citeu, trim=True)
# hide one reader per multi-reader doc for the §8 evaluation
# (the reference's leave-one-out demo, README.md:512-560)
citeu, held = tm.holdout_readers(citeu, seed=7)
base = tm.LDA(citeu, CTPF_K, device=DEVICE, seed=7)
base.train(iter=15, tol=0.0, checkelbo=np.inf, printelbo=False)
ctpf = tm.CTPF(citeu, CTPF_K, device=DEVICE, seed=7).warm_start_from(base)
ctpf.train(iter=20, tol=0.0, checkelbo=10)
print("\ntop recommendations for user 1:")
ctpf.showurecs(users=1, M=5)
done(f"ELBO {ctpf.elbo:.1f}")

# ── 7. checkpoint/resume (beyond the reference) ──
section(7, "checkpoint save / resume")
ckpt = os.path.join(tempfile.mkdtemp(prefix="tmvb_walkthrough_"), "lda.ckpt")
tm.save_checkpoint(ckpt, lda)
resumed = tm.load_checkpoint(ckpt, corp, device=DEVICE)
resumed.train(iter=5, tol=0.0, checkelbo=5)
print("resumed model continues from ELBO", f"{resumed.elbo:.1f}")
done(f"ELBO {resumed.elbo:.1f}")

# ── 8. evaluation metrics (beyond the reference) ──
section(8, "held-out perplexity, topic coherence, recommender ranks")
ppl = tm.perplexity(test_corp, m)
coh = tm.topic_coherence(lda, N=8)
print(f"held-out perplexity: {ppl:.1f}  (vocab size {len(corp.vocab)})")
print("UMass coherence per topic:", np.round(coh, 1))
# leave-one-reader-out (reference README.md:512-560, plots.R:20-31):
# where does the trained CTPF rank the §6 held-out readers?
recs = tm.ranked_users(ctpf, held)     # rank each doc once, share across metrics
ranks = tm.heldout_reader_rank(ctpf, held, recs=recs)
recall = tm.recall_at_k(ctpf, held, 20, recs=recs)
print(f"CTPF leave-one-reader-out: median rank "
      f"{np.median(ranks):.3f} (0=top), "
      f"recall@20 {recall:.2f} "
      f"over {len(held)} held-out readers")
done(f"perplexity {ppl:.1f}, recall@20 {recall:.2f}")

# ── 9. streaming + online training (beyond the reference) ──
section(9, "beyond-memory streaming and one-pass online training")
packed = tm.synth_packed_nsf_scale(M=STREAM_DOCS, V=2000, mean_terms=40,
                                   chunk_docs=min(256, STREAM_BATCH))
s = tm.StreamingLDA(packed, 20, batch_docs=STREAM_BATCH,
                    chunk_docs=min(256, STREAM_BATCH), device=DEVICE)
s.train_online(epochs=1, tau0=8.0, checkelbo=1, printelbo=False)
print(f"one online pass over {packed.M} host-resident docs: "
      f"ELBO {s.trace[-1][1]:.0f}")

# literal disk streaming (reference todo.txt:6): corpus saved once as
# mmap-loadable .npy files, per-doc state in writable memmaps; neither
# needs to fit in RAM
ddir = tempfile.mkdtemp(prefix="tmvb_disk_")
tm.save_packed(ddir + "/corp", packed)
disk = tm.load_packed(ddir + "/corp")          # read-only memmaps
sd = tm.StreamingLDA(disk, 20, batch_docs=STREAM_BATCH,
                     chunk_docs=min(256, STREAM_BATCH),
                     state_dir=ddir + "/state", device=DEVICE)   # writable state memmaps
sd.train(iter=2, checkelbo=1, printelbo=False)
print(f"disk-backed stream (corpus+state memmapped): "
      f"ELBO {sd.trace[-1][1]:.0f}, state on disk: "
      f"{type(sd.gamma).__name__}")
done(f"ELBO online {s.trace[-1][1]:.1f}, disk {sd.trace[-1][1]:.1f}")

# ── 10. HMTM (the model the reference never finished) ──
section(10, "HMTM: order-aware topics (completed reference stub)")
# ordered corpus: sticky topic chains over topic-disjoint vocabularies
rng = np.random.default_rng(0)
Kh, Vh = 3, 30
fam = [list(range(k * 10, (k + 1) * 10)) for k in range(Kh)]
docs = []
for _ in range(HMTM_DOCS):
    z, terms = rng.integers(Kh), []
    for _n in range(60):
        if rng.random() > 0.95:
            z = rng.integers(Kh)
        terms.append(int(rng.choice(fam[z])) + 1)
    docs.append(tm.Document(terms=terms, counts=[1] * len(terms)))
ocorp = tm.Corpus(docs=docs,
                  vocab={j + 1: f"fam{j // 10}_w{j % 10}" for j in range(Vh)})
hm = tm.HMTM(ocorp, Kh, device=DEVICE, seed=1)
hm.train(iter=25, tol=0.0, checkelbo=5)
hm.showtopics(V=5, cols=3)
trans = hm.transdist(1)
print("\ndoc 1 expected transition diag (stickiness):",
      np.round(np.diag(trans), 2))
shuf = tm.Corpus(docs=[tm.Document(terms=rng.permutation(d.terms).tolist(),
                                   counts=list(d.counts))
                       for d in docs[:50]], vocab=dict(ocorp.vocab))
sub = tm.Corpus(docs=docs[:50], vocab=dict(ocorp.vocab))
ppl_ordered, ppl_shuffled = tm.perplexity(sub, hm), tm.perplexity(shuf, hm)
print(f"order-aware perplexity: ordered {ppl_ordered:.1f} "
      f"vs shuffled {ppl_shuffled:.1f} "
      "(the chain structure carries real likelihood)")
done(f"ELBO {hm.elbo:.1f}, perplexity ordered {ppl_ordered:.1f} "
     f"vs shuffled {ppl_shuffled:.1f}")

print("\nwalkthrough complete.")
