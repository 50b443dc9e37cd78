"""The port's corpus pipeline against the JAX package, on CPU.

Everything here is host code, so every result must be exact: the same
files byte for byte, equal corpora (documents, vocabularies and users, in
the same order), the same printed text and the same errors, from the same
inputs made with numpy from a seed.  ``readcorp`` runs through both its
routes (the native parser and pure Python) in both packages.
"""

import itertools
import os

import numpy as np
import pytest

import topicmodelsvb_jl_tpu as tm
import topicmodelsvb_jl_tpu.native as jax_native
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import corpus as torch_corpus

STAMPED = dict(M=30, V=40, K=3, U=12, seed=5, mean_tokens=15, mean_terms=8,
               mean_readers=3, n_slices=3, drift=0.1)


def _fields(doc):
    return (doc.terms, doc.counts, doc.readers, doc.ratings, doc.title, doc.stamp)


def assert_same_corpus(a, b):
    assert len(a.docs) == len(b.docs)
    for d, (x, y) in enumerate(zip(a.docs, b.docs), start=1):
        assert _fields(x) == _fields(y), f"document {d}"
    assert list(a.vocab.items()) == list(b.vocab.items())
    assert list(a.users.items()) == list(b.users.items())


def _titled(pkg, **kw):
    corp = pkg.synth_corpus(**kw)
    for d, doc in enumerate(corp.docs, start=1):
        if d % 3:
            doc.title = f"title of document {d}"
    return corp


def _outcome(fn):
    """What ``fn`` returns, or the type name and text of what it raises."""
    try:
        return "ok", fn()
    except Exception as e:   # compared across packages: both must fail alike
        return type(e).__name__, str(e)


@pytest.mark.filterwarnings("ignore:ratings require readers")
@pytest.mark.parametrize("counts,readers,ratings,stamps",
                         list(itertools.product([False, True], repeat=4)))
def test_writecorp_readcorp_match_jax(tmp_path, monkeypatch, counts, readers, ratings, stamps):
    """Files byte-identical for every combination of the four switches,
    with titles, vocab and user files, each delimiter; ``readcorp`` gives
    equal corpora through both routes in both packages."""
    jc, tc = _titled(tm, **STAMPED), _titled(tt, **STAMPED)
    flags = dict(counts=counts, readers=readers, ratings=ratings, stamps=stamps)
    for delim in (",", ";"):
        files = {}
        for name, pkg, corp in (("jax", tm, jc), ("torch", tt, tc)):
            files[name] = {k: str(tmp_path / f"{name}_{k}_{ord(delim)}.txt")
                           for k in ("docfile", "vocabfile", "userfile", "titlefile")}
            pkg.writecorp(corp, delim=delim, **files[name], **flags)
        for k in files["jax"]:
            with open(files["jax"][k], "rb") as f, open(files["torch"][k], "rb") as g:
                assert f.read() == g.read(), (k, delim)
        for native in (True, False):
            with monkeypatch.context() as mp:
                if not native:
                    mp.setattr(jax_native, "get_lib", lambda: None)
                    mp.setattr(torch_corpus, "parse_delimited_ints", lambda data, delim: None)
                a = tm.readcorp(delim=delim, **files["jax"], **flags)
                b = tt.readcorp(delim=delim, **files["torch"], **flags)
            assert tt.readcorp.route == ("native" if native and not stamps else "python")
            assert_same_corpus(a, b)
            assert len(b.docs) == STAMPED["M"] and b.users == tc.users
            assert [d.title for d in b.docs] == [d.title for d in tc.docs]
            assert all(x.terms == y.terms for x, y in zip(b.docs, tc.docs))


@pytest.mark.parametrize("text", [
    "1,2\n1,1\n3,x\n1,1\n",        # a bad character in document 2
    "1,2\n1,1\n3,0\n1,1\n",        # term key 0 in document 2
    "4,5\n1,1\n6,7\n1\n",          # terms and counts of unequal length in document 2
    "1,2\n1,1\n3,\n1\n",           # a trailing delimiter in document 2
    "1\n1\n2\n2\n+3\n-1\n",        # '+' parses in Python only; count -1 in document 3
])
def test_malformed_document_names_the_same_document(tmp_path, text):
    path = tmp_path / "docs.txt"
    path.write_text(text)
    a = _outcome(lambda: tm.readcorp(docfile=str(path), counts=True))
    b = _outcome(lambda: tt.readcorp(docfile=str(path), counts=True))
    assert a[0] == "CorpusError" and a == b


def _messy_spec(seed=3):
    """A corpus that every mutator changes: sparse keys, doc keys missing
    from the dicts, dict keys no document uses, duplicate and stop-word
    names, repeated terms, empty documents, unknown readers."""
    r = np.random.default_rng(seed)
    names = ["the", "The", "of", "and", "alpha", "beta", "Gamma", "delta", "alpha", "zeta",
             "eta", "a", "theta", "iota", "Kappa", "lambda", "beta", "mu"]
    vkeys = sorted(int(k) for k in r.choice(np.arange(1, 40), size=len(names), replace=False))
    unames = ["ann", "bob", "ann", "cy", "dee", "eve", "bob", "fay"]
    ukeys = sorted(int(k) for k in r.choice(np.arange(1, 20), size=len(unames), replace=False))
    docs = []
    for d in range(40):
        n = int(r.integers(0, 9))
        terms = [int(x) for x in r.choice(vkeys[:-3] + [41, 43], size=n)]
        counts = [int(x) for x in r.integers(1, 5, size=n)]
        nr = int(r.integers(0, 4))
        readers = [int(x) for x in r.choice(ukeys[:-2] + [25], size=nr, replace=False)]
        ratings = [int(x) for x in r.integers(1, 3, size=nr)]
        docs.append(dict(terms=terms, counts=counts, readers=readers, ratings=ratings,
                         title=f"doc {d + 1}" if d % 4 else ""))
    return docs, dict(zip(vkeys, names)), dict(zip(ukeys, unames))


def _messy(pkg):
    docs, vocab, users = _messy_spec()
    return pkg.Corpus(docs=[pkg.Document(**d) for d in docs], vocab=vocab, users=users)


MUTATIONS = {
    "abridge_corp": lambda p, c: p.abridge_corp(c, 20),
    "alphabetize_corp": lambda p, c: p.alphabetize_corp(c),
    "alphabetize_corp_vocab_only": lambda p, c: p.alphabetize_corp(c, users=False),
    "remove_terms": lambda p, c: p.remove_terms(c, ["THE", "alpha", "nosuch"]),
    "compact_corp_missing_keys": lambda p, c: p.compact_corp(c),
    "compact_corp": lambda p, c: (p.pad_corp(c), p.compact_corp(c)),
    "condense_corp": lambda p, c: p.condense_corp(c),
    "expand_corp": lambda p, c: p.expand_corp(c),
    "pad_corp": lambda p, c: p.pad_corp(c),
    "remove_empty_docs": lambda p, c: p.remove_empty_docs(c),
    "remove_redundant": lambda p, c: p.remove_redundant(c),
    "stop_corp": lambda p, c: p.stop_corp(c),
    "stop_corp_own_list": lambda p, c: p.stop_corp(c, ["ALPHA", "mu"]),
    "trim_corp": lambda p, c: p.trim_corp(c),
    "trim_docs": lambda p, c: p.trim_docs(c),
    "trim_docs_terms_only": lambda p, c: p.trim_docs(c, readers=False),
}
FIXCORP = {
    "defaults": {}, "abridge": dict(abridge=20), "alphabetize": dict(alphabetize=True),
    "alphabetize_users_off": dict(alphabetize=True, users=False),
    "condense": dict(condense=True), "pad": dict(pad=True),
    "remove_empty_docs": dict(remove_empty_docs=True),
    "remove_redundant": dict(remove_redundant=True),
    "remove_terms": dict(remove_terms=["eta", "KAPPA"]), "stop": dict(stop=True),
    "trim": dict(trim=True), "trim_vocab_off": dict(trim=True, vocab=False),
    "everything": dict(abridge=2, alphabetize=True, condense=True, remove_empty_docs=True,
                       remove_redundant=True, remove_terms=["beta"], stop=True, trim=True),
}


@pytest.mark.parametrize("case", list(MUTATIONS) + [f"fixcorp_{k}" for k in FIXCORP])
def test_mutators_and_fixcorp_match_jax(case):
    if case.startswith("fixcorp_"):
        kw = FIXCORP[case[len("fixcorp_"):]]
        run = lambda p, c: p.fixcorp(c, **kw)
    else:
        run = MUTATIONS[case]
    base_j, base_t = _messy(tm), _messy(tt)
    jc, tc = base_j.deepcopy(), base_t.deepcopy()
    a, b = _outcome(lambda: run(tm, jc)), _outcome(lambda: run(tt, tc))
    assert a[0] == b[0] and (a[0] == "ok" or a == b)
    assert_same_corpus(jc, tc)
    assert_same_corpus(base_j, base_t)   # the deep copies were the ones changed
    if case == "compact_corp_missing_keys":
        assert a[0] == "KeyError"
    else:
        changed = (_fields(x) != _fields(y) for x, y in zip(tc.docs, base_t.docs))
        assert (any(changed) or len(tc.docs) != len(base_t.docs)
                or tc.vocab != base_t.vocab or tc.users != base_t.users), case
    if case.startswith("fixcorp_"):
        tt.check_corp(tc)


def _broken(pkg, what):
    ok = pkg.synth_corpus(M=12, V=10, K=2, U=5, seed=1, mean_tokens=8, mean_terms=4)
    if what == "term_not_in_vocab":
        ok.docs[3].terms[0] = 11
    elif what == "user_not_in_users":
        ok.docs[2].readers[0] = 6
    elif what == "vocab_not_unit_range":
        ok.vocab[12] = "extra"
    elif what == "users_not_unit_range":
        ok.users[7] = "extra"
    elif what == "broken_document":
        ok.docs[4].counts[0] = 0
    elif what == "nonpositive_vocab_key":
        ok.vocab[0] = "zero"
    return ok


@pytest.mark.parametrize("what", ["valid", "term_not_in_vocab", "user_not_in_users",
                                  "vocab_not_unit_range", "users_not_unit_range",
                                  "broken_document", "nonpositive_vocab_key"])
def test_check_corp_raises_as_jax(what):
    a = _outcome(lambda: tm.check_corp(_broken(tm, what)))
    b = _outcome(lambda: tt.check_corp(_broken(tt, what)))
    assert a == b and (a[0] == "ok") == (what == "valid")


def test_showdocs_showtitles_print_as_jax(capsys):
    outs = []
    for pkg in (tm, tt):
        corp = _titled(pkg, M=6, V=12, K=2, seed=4, mean_tokens=6, mean_terms=4)
        corp.docs[1].terms, corp.docs[1].counts = [], []
        loose = pkg.Document(terms=[2, 5], title="a loose document")
        bad = pkg.Document(terms=[13])
        got = []
        for fn, args in ((pkg.showdocs, ()), (pkg.showdocs, (2,)), (pkg.showdocs, ([1, 3],)),
                         (pkg.showdocs, (loose,)), (pkg.showdocs, ([loose, 4],)),
                         (pkg.showdocs, (7,)), (pkg.showdocs, (bad,)),
                         (pkg.showtitles, ()), (pkg.showtitles, (3,)),
                         (pkg.showtitles, ([loose, 1, 2],)), (pkg.showtitles, (0,))):
            res = _outcome(lambda: fn(corp, *args))
            got.append((res, capsys.readouterr().out))
        got.append((pkg.getvocab(corp), pkg.getusers(corp)))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][0][1].startswith(" ●●● Document 1\n")


def test_word_lists_match_jax():
    for name in ("stopwords.txt", "englishwords.txt"):
        with open(os.path.join(os.path.dirname(tm.__file__), "data", name), "rb") as f, \
                open(os.path.join(os.path.dirname(tt.__file__), "data", name), "rb") as g:
            assert f.read() == g.read(), name
    assert tt.load_stopwords() == tm.load_stopwords() and len(tt.load_stopwords()) == 545
    assert tt.load_englishwords() == tm.datasets.load_englishwords()


@pytest.mark.parametrize("loader,subset", [("load_nsf", 20), ("load_citeu", 60),
                                           ("load_mac", 12)])
def test_dataset_loaders_match_jax(loader, subset, tmp_path, monkeypatch):
    """Synthesized at the published widths (no docfile), then read from a
    ``TMVB_DATASETS`` directory holding the reference's file layout."""
    monkeypatch.delenv("TMVB_DATASETS", raising=False)
    with pytest.warns(UserWarning, match="not available"):
        a = getattr(tm.datasets, loader)(seed=3, subset=subset)
    with pytest.warns(UserWarning, match="not available"):
        b = getattr(tt, loader)(seed=3, subset=subset)
    assert_same_corpus(a, b)
    assert len(b.docs) == subset
    name, files = {"load_nsf": ("nsf", dict(docfile="nsfdocs", vocabfile="nsfvocab",
                                            titlefile="nsftitles")),
                   "load_citeu": ("citeu", dict(docfile="citeudocs", vocabfile="citeuvocab",
                                                userfile="citeuusers",
                                                titlefile="citeutitles")),
                   "load_mac": ("mac", dict(docfile="macdocs", vocabfile="maclex",
                                            titlefile="mactitles"))}[loader]
    (tmp_path / name).mkdir()
    for doc in b.docs:
        doc.title = f"paper {len(doc.terms)}"
    tt.writecorp(b, counts=True, readers=loader == "load_citeu", stamps=loader == "load_mac",
                 **{k: str(tmp_path / name / f"{v}.txt") for k, v in files.items()})
    monkeypatch.setenv("TMVB_DATASETS", str(tmp_path))
    a = getattr(tm.datasets, loader)(seed=3, subset=subset // 2)
    c = getattr(tt, loader)(seed=3, subset=subset // 2)
    assert_same_corpus(a, c)
    assert [d.title for d in c.docs] == [d.title for d in b.docs[: subset // 2]]
