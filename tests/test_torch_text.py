"""The port's text nodes and its native frontend against the JAX package on
the CPU, on the same strings and numpy-seeded corpora. Everything here is
host integer or string work, so every comparison is exact (bit-equal
hashes, equal tokens, n-grams, ids, indices and values), except the packed
features' values under a log tf function (float32 table against float64
pairs, rtol 1e-6, as the JAX suite holds them) and the language model's
scores (the same float64 arithmetic, equal).

Mirrors ``tests/nodes/test_nlp.py``, ``test_native_hashing.py`` and
``test_packed_features.py``. The port's ``text_frontend_batch`` returns no
document for an empty corpus where the JAX package's returns one (pinned
below).
"""

import numpy as np
import pytest
import torch

from keystone_tpu import native as jnative
from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.nodes import nlp as jnlp
from keystone_tpu.nodes.nlp import packed_features as jpf
from keystone_tpu.nodes.nlp import stupid_backoff as jsb
from keystone_tpu.nodes.stats import TermFrequency as JTermFrequency
from keystone_tpu.nodes.util import AllSparseFeatures as JAllSparseFeatures
from keystone_tpu.nodes.util import CommonSparseFeatures as JCommonSparseFeatures
from keystone_tpu.pipelines import stupid_backoff_pipeline as jsbp
from keystone_tpu_torch import native
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes import nlp
from keystone_tpu_torch.nodes.nlp import packed_features as pf
from keystone_tpu_torch.nodes.nlp.indexers import NaiveBitPackIndexer, NGramIndexerImpl
from keystone_tpu_torch.nodes.nlp.stupid_backoff import (
    PackedStupidBackoffModel,
    StupidBackoffModel,
)
from keystone_tpu_torch.nodes.stats import TermFrequency
from keystone_tpu_torch.nodes.util import AllSparseFeatures, CommonSparseFeatures
from keystone_tpu_torch.pipelines import stupid_backoff_pipeline as sbp
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


@pytest.fixture
def needs_native():
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain to build the native frontend")


def _rows(sr):
    """A padded batch (either package's) → per-row sorted (index, value)
    pairs of its nonzero entries."""
    idx = np.asarray(sr.indices.cpu() if hasattr(sr.indices, "cpu") else sr.indices)
    val = np.asarray(sr.values.cpu() if hasattr(sr.values, "cpu") else sr.values)
    out = []
    for i in range(idx.shape[0]):
        keep = val[i] != 0
        out.append(sorted(zip(idx[i][keep].tolist(), val[i][keep].tolist())))
    return out


def _assert_same_rows(got, want):
    np.testing.assert_array_equal(got.indices.cpu().numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.cpu().numpy(), np.asarray(want.values))
    assert got.num_features == want.num_features


# ---- strings, tokens and n-grams -----------------------------------------------

STRINGS = ["  The quick BROWN fo.X ", " ! !.,)JumpeD. ovER the LAZy DOG.. ! ", "", "++--++",
           "a+b a_b a1b 0x7F under_score__double", "héllo wörld ñ", "tab\tnewline\nx"]


@pytest.mark.parametrize("name", ["Trim", "LowerCase", "Tokenizer"])
def test_string_nodes_match_jax(name):
    got, want = getattr(nlp, name)(), getattr(jnlp, name)()
    assert [got.apply(s) for s in STRINGS] == [want.apply(s) for s in STRINGS]


def test_tokenizer_keeps_a_leading_empty_token():
    assert [nlp.Tokenizer().apply(s) for s in STRINGS[:2]] == [
        ["", "The", "quick", "BROWN", "fo", "X"],
        ["", "JumpeD", "ovER", "the", "LAZy", "DOG"],
    ]


DOCS = ["Pipelines are awesome", "NLP is awesome", "a quick brown fox jumped over a lazy dog a a"]


@pytest.mark.parametrize("orders", [[1], [2, 3], [1, 2, 3, 4], [6]])
def test_ngrams_featurizer_matches_jax(orders):
    tok = nlp.Tokenizer()
    got = [nlp.NGramsFeaturizer(orders).apply(tok.apply(d)) for d in DOCS]
    want = [jnlp.NGramsFeaturizer(orders).apply(tok.apply(d)) for d in DOCS]
    assert got == want


@pytest.mark.parametrize("orders", [[0, 1], [1, 3]])
def test_ngram_orders_are_validated(orders):
    with pytest.raises(ValueError):
        nlp.NGramsFeaturizer(orders)


@pytest.mark.parametrize("mode", ["default", "noadd"])
def test_ngrams_counts_match_jax(mode):
    tok = nlp.Tokenizer()
    grams = [nlp.NGramsFeaturizer([1, 2]).apply(tok.apply(d)) for d in DOCS]
    got = nlp.NGramsCounts(mode).apply_batch(Dataset.from_items(grams)).collect()
    want = jnlp.NGramsCounts(mode).apply_batch(JDataset.from_items(grams)).collect()
    assert got == want
    if mode == "default":
        assert got[0] == (("a",), 4)


def test_word_frequency_encoder_matches_jax():
    tok = nlp.Tokenizer()
    text = ["Winter coming", "Winter Winter is coming"]
    got = nlp.WordFrequencyEncoder().fit(Dataset.from_items([tok.apply(t) for t in text]))
    want = jnlp.WordFrequencyEncoder().fit(JDataset.from_items([tok.apply(t) for t in text]))
    assert got.word_index == want.word_index
    assert got.unigram_counts == want.unigram_counts == {0: 3, 1: 2, 2: 1}
    assert [got.apply(tok.apply(t)) for t in text] == [[0, 1], [0, 0, 2, 1]]
    assert got.apply(["hi"]) == [-1]


# ---- hashes --------------------------------------------------------------------

def _random_tokens(rng, n):
    pieces = ["a", "bc", "ω", "λx", "naïve", "日本", "", "Z" * 40, "0", "\x00x"]
    return ["".join(rng.choice(pieces, size=rng.integers(1, 4))) for _ in range(n)]


HASH_TERMS = ["", "a", "abc", "hello", "polygenelubricants", "Seq", "日本語", "\x00",
              1, -7, 2 ** 31 + 5, True, False, ("a", "b"), ["x", 3, ("y",)]]


@pytest.mark.parametrize("term", HASH_TERMS, ids=repr)
def test_scala_hashes_are_bit_equal(term):
    assert nlp.scala_hash(term) == jnlp.scala_hash(term)


def test_java_hash_golden_values():
    assert nlp.java_string_hash("hello") == 99162322
    assert nlp.java_string_hash("polygenelubricants") == -2147483648
    rng = np.random.default_rng(0)
    for t in _random_tokens(rng, 300):
        assert nlp.java_string_hash(t) == jnlp.java_string_hash(t)
    hashes = [int(rng.integers(-2 ** 31, 2 ** 31)) for _ in range(5)]
    assert nlp.murmur3_seq_hash(hashes) == jnlp.murmur3_seq_hash(hashes)


@pytest.mark.parametrize("dims", [2, 64, 4000])
def test_hashing_tf_matches_jax(dims):
    doc = ["1", "2", "4", "4", "4", "4", "2"]
    got, want = nlp.HashingTF(dims).apply(doc), jnlp.HashingTF(dims).apply(doc)
    assert got == want
    assert sum(v for _, v in got) == 7.0


@pytest.mark.parametrize("orders", [[1], [1, 2], [2, 3], [1, 2, 3, 4]])
@pytest.mark.parametrize("dims", [64, 4096])
def test_ngrams_hashing_tf_equals_composed_and_jax(orders, dims):
    line = nlp.Tokenizer().apply("a quick brown fox jumped over a lazy dog a a")
    rolling = nlp.NGramsHashingTF(orders, dims).apply(line)
    assert rolling == nlp.HashingTF(dims).apply(nlp.NGramsFeaturizer(orders).apply(line))
    assert rolling == jnlp.NGramsHashingTF(orders, dims).apply(line)


@pytest.mark.parametrize("native_off", [False, True], ids=["native", "python"])
@pytest.mark.parametrize("kind", ["hashing", "ngrams"])
def test_hashing_batches_match_jax_and_the_item_path(kind, native_off, monkeypatch):
    if native_off:
        monkeypatch.setenv("KEYSTONE_NO_NATIVE", "1")
    rng = np.random.default_rng(1)
    docs = [_random_tokens(rng, int(rng.integers(0, 20))) for _ in range(30)]
    node, ref = ((nlp.HashingTF(257), jnlp.HashingTF(257)) if kind == "hashing" else
                 (nlp.NGramsHashingTF([1, 2, 3], 1023), jnlp.NGramsHashingTF([1, 2, 3], 1023)))
    got = node.apply_batch(Dataset.from_items(docs)).payload
    assert _rows(got) == [node.apply(doc) for doc in docs]
    assert _rows(got) == _rows(ref.apply_batch(JDataset.from_items(docs)).payload)


def test_non_string_and_surrogate_terms_take_the_python_path():
    bad = b"caf\xff".decode("utf-8", errors="surrogateescape")
    docs = [[1, 2, ("a", "b")], ["x", 3], ["ok", bad], [bad]]
    tf = nlp.HashingTF(97)
    assert _rows(tf.apply_batch(Dataset.from_items(docs)).payload) == [tf.apply(d) for d in docs]


# ---- the native library --------------------------------------------------------

def test_native_java_hash_is_bit_equal(needs_native):
    tokens = _random_tokens(np.random.default_rng(0), 500) + ["", "a", "\x00"]
    before = native.CALLS["java_string_hash_batch"]
    got = native.java_string_hash_batch(tokens)
    assert native.CALLS["java_string_hash_batch"] == before + 1
    np.testing.assert_array_equal(got, jnative.java_string_hash_batch(tokens))
    np.testing.assert_array_equal(got, [nlp.java_string_hash(t) for t in tokens])


FRONTEND_DOCS = [
    "  Hello, World!  ", "+leading separators keep ONE empty token",
    "trailing separators drop!!!", "", "   ", "++--++",
    "a+b a_b a1b 0x7F under_score__double", "repeat repeat REPEAT rePEAT",
    "tab\tnewline\nmixed \x0b\x0c\r whitespace", "\x1chello world\x1f",
]


def _py_frontend(docs):
    vocab = {}
    ids = pf._token_ids(pf._py_tokenize_raw(docs, True, True), vocab, grow=True)
    by_id = [None] * len(vocab)
    for t, i in vocab.items():
        by_id[i] = t
    return ids, by_id


def test_text_frontend_matches_python_and_jax(needs_native):
    ids, off, new_tokens = native.text_frontend_batch(FRONTEND_DOCS, [], grow=True)
    want_ids, want_vocab = _py_frontend(FRONTEND_DOCS)
    got_ids = native.doc_slices(ids, off)
    assert len(got_ids) == len(want_ids) == len(FRONTEND_DOCS)
    for g, w in zip(got_ids, want_ids):
        np.testing.assert_array_equal(g, w)
    assert new_tokens == want_vocab
    j_ids, j_off, j_new = jnative.text_frontend_batch(FRONTEND_DOCS, [], grow=True)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(off, j_off)
    assert new_tokens == j_new


def test_text_frontend_lookup_marks_oov_and_declines_non_ascii(needs_native):
    _, _, vocab_tokens = native.text_frontend_batch(["alpha beta gamma"], [], grow=True)
    ids, _, new_tokens = native.text_frontend_batch(["beta unknown alpha"], vocab_tokens,
                                                    grow=False)
    assert new_tokens == []
    np.testing.assert_array_equal(ids, [1, -1, 0])
    assert native.text_frontend_batch(["héllo wörld"], [], grow=True) is None


def test_an_empty_corpus_returns_no_document(needs_native):
    """The divergence from the JAX package: its frontend splits an empty
    corpus into one empty document, the port's returns none."""
    ids, off, new = native.text_frontend_batch([], [], grow=True)
    assert len(ids) == 0 and off.tolist() == [0] and new == []
    assert pf._frontend_ids([], {}, True, True, True, []) == []
    j_ids = jpf._frontend_ids([], {}, True, True, True, [])
    assert len(j_ids) == 1 and len(j_ids[0]) == 0  # the reference's spurious document


def test_packed_grams_unique_matches_numpy_and_jax(needs_native):
    rng = np.random.default_rng(11)
    ids_list = [rng.integers(-1, 6, size=rng.integers(0, 30)).astype(np.int64)
                for _ in range(50)] + [np.empty(0, dtype=np.int64)]
    for orders in ([1], [1, 2], [1, 2, 3], [2, 3]):
        got = native.packed_grams_unique(ids_list, orders)
        for a, b, c in zip(got, pf._per_doc_unique(*pf._corpus_grams(ids_list, orders)),
                           jnative.packed_grams_unique(ids_list, orders)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert native.packed_grams_unique([np.arange(5, dtype=np.int64)], [4]) is None


def test_no_native_falls_back_and_require_lib_raises(monkeypatch):
    monkeypatch.setenv("KEYSTONE_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert native.text_frontend_batch(["a b"], [], grow=True) is None
    with pytest.raises(RuntimeError, match="KEYSTONE_NO_NATIVE"):
        native.require_lib()


# ---- packed features -----------------------------------------------------------

def _random_docs(n_docs, vocab_size, seed, min_len=3, max_len=40):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_size)]
    return [[words[i] for i in rng.integers(0, vocab_size, int(rng.integers(min_len, max_len)))]
            for _ in range(n_docs)]


def _log1p_tf(x):
    return 1 + np.log(x)


def _present(x):
    return 1


@pytest.mark.parametrize("orders,tf", [([1, 2], _present), ([1, 2, 3], None), ([2], _log1p_tf)],
                         ids=["uni-bi", "to-tri", "bi-log"])
def test_packed_features_match_jax_and_the_composed_chain(orders, tf):
    docs_tr, docs_te = _random_docs(60, 30, seed=1), _random_docs(25, 35, seed=2)
    vec = pf.PackedTextFeatures(orders, 100, tf).fit(Dataset.from_items(docs_tr))
    jvec = jpf.PackedTextFeatures(orders, 100, tf).fit(JDataset.from_items(docs_tr))
    np.testing.assert_array_equal(vec.selected, jvec.selected)
    np.testing.assert_array_equal(vec.columns, jvec.columns)
    assert vec.vocab == jvec.vocab
    for docs in (docs_tr, docs_te):
        _assert_same_rows(vec.apply_batch(Dataset.from_items(docs)).payload,
                          jvec.apply_batch(JDataset.from_items(docs)).payload)
    # the composed chain, in the port
    feats = [TermFrequency(tf).apply(nlp.NGramsFeaturizer(orders).apply(d)) for d in docs_te]
    train_feats = [TermFrequency(tf).apply(nlp.NGramsFeaturizer(orders).apply(d))
                   for d in docs_tr]
    composed = CommonSparseFeatures(100).fit(Dataset.from_items(train_feats))
    np.testing.assert_allclose(
        vec.apply_batch(Dataset.from_items(docs_te)).payload.to_dense().numpy(),
        composed.apply_batch(Dataset.from_items(feats)).payload.to_dense().numpy(), rtol=1e-6)


@pytest.mark.parametrize("native_off", [False, True], ids=["native", "python"])
def test_packed_features_on_raw_strings_match_jax(native_off, monkeypatch):
    if native_off:
        monkeypatch.setenv("KEYSTONE_NO_NATIVE", "1")
    train_raw = FRONTEND_DOCS * 3
    serve_raw = ["Hello under_score unknownTOKEN b a", "+a b!!", "héllo a"]
    vec = pf.PackedTextFeatures([1, 2], 32, _present).fit(Dataset.from_items(train_raw))
    jvec = jpf.PackedTextFeatures([1, 2], 32, _present).fit(JDataset.from_items(train_raw))
    tok = pf.PackedTextFeatures([1, 2], 32, _present).fit(
        Dataset.from_items(pf._py_tokenize_raw(train_raw, True, True)))
    np.testing.assert_array_equal(vec.selected, jvec.selected)
    np.testing.assert_array_equal(vec.selected, tok.selected)
    np.testing.assert_array_equal(vec.columns, jvec.columns)
    for docs in (train_raw, serve_raw):
        got = vec.apply_batch(Dataset.from_items(docs)).payload
        _assert_same_rows(got, jvec.apply_batch(JDataset.from_items(docs)).payload)
        _assert_same_rows(got, tok.apply_batch(
            Dataset.from_items(pf._py_tokenize_raw(docs, True, True))).payload)


def test_packed_features_use_the_native_frontend(needs_native):
    before = dict(native.CALLS)
    vec = pf.PackedTextFeatures([1, 2], 50, _present).fit(Dataset.from_items(FRONTEND_DOCS))
    vec.apply_batch(Dataset.from_items(["hello world", "a b"]))
    assert native.CALLS["text_frontend_batch"] == before.get("text_frontend_batch", 0) + 2
    assert native.CALLS["packed_grams_unique"] == before.get("packed_grams_unique", 0) + 2


def test_packed_feature_columns_follow_the_composed_ranking():
    docs = [["a", "b", "a"], ["b", "c"], ["a", "b"]]
    feats = [TermFrequency(_present).apply(nlp.NGramsFeaturizer([1, 2]).apply(d)) for d in docs]
    vec_c = CommonSparseFeatures(4).fit(Dataset.from_items(feats))
    vec_p = pf.PackedTextFeatures([1, 2], 4, _present).fit(Dataset.from_items(docs))
    for gram, col in vec_c.feature_space.items():
        assert any(c == col for c, _ in vec_p.apply(list(gram))), (gram, col)


def test_packed_apply_keeps_zero_tf_pairs():
    tf = lambda x: float(np.log(x))  # noqa: E731 - a count of 1 maps to 0.0
    docs = [["a", "b", "a", "c"], ["b", "c", "c"]]
    vec = pf.PackedTextFeatures([1, 2], 20, tf).fit(Dataset.from_items(docs))
    jvec = jpf.PackedTextFeatures([1, 2], 20, tf).fit(JDataset.from_items(docs))
    for d in docs:
        got, want = vec.apply(d), jvec.apply(d)
        assert got == want
        assert any(v == 0.0 for _, v in got)


def test_packed_features_reject_high_orders_and_a_big_vocabulary(monkeypatch):
    with pytest.raises(ValueError):
        pf.PackedTextFeatures([1, 2, 3, 4], 10)
    monkeypatch.setattr(pf, "_MAX_VOCAB", 3)
    with pytest.raises(ValueError):
        pf.PackedTextFeatures([1], 10).fit(Dataset.from_items([["a", "b", "c", "d"]]))


def test_packed_empty_and_short_docs():
    docs = [["a"], [], ["a", "b", "c"]]
    vec = pf.PackedTextFeatures([1, 2], 10, _present).fit(Dataset.from_items(docs))
    dense = vec.apply_batch(Dataset.from_items(docs)).payload.to_dense()
    assert dense.shape[0] == 3 and dense[1].sum() == 0


def test_packed_fit_then_apply_serves_the_cached_grams():
    docs = _random_docs(20, 12, seed=7)
    want = pf.PackedTextFeatures([1, 2], 50, _present).fit(Dataset.from_items(docs))
    want = want.apply_batch(Dataset.from_items(docs)).payload.to_dense()
    gen_ds = Dataset.from_items([iter(d) for d in docs])
    vec = pf.PackedTextFeatures([1, 2], 50, _present).fit(gen_ds)
    assert torch.equal(vec.apply_batch(gen_ds).payload.to_dense(), want)
    # a change of size since fit featurizes again
    docs2 = [list(d) for d in _random_docs(10, 8, seed=9)]
    ds = Dataset.from_items(docs2)
    vec2 = pf.PackedTextFeatures([1], 30, _present).fit(ds)
    ds.payload[0].append(ds.payload[1][0])
    got = vec2.apply_batch(ds).payload.to_dense()
    assert torch.equal(got, vec2.apply_batch(Dataset.from_items(ds.payload)).payload.to_dense())


def test_packed_vectorizer_puts_its_rows_on_its_device():
    vec = pf.PackedTextFeatures([1], 10, _present, device="cpu").fit(
        Dataset.from_items(["a b", "b c"]))
    assert vec.device == "cpu"
    rows = vec.apply_batch(Dataset.from_items(["a c"])).payload
    assert rows.device == torch.device("cpu") and rows.indices.dtype == torch.int64


# ---- sparse features and term frequency ---------------------------------------

def test_term_frequency_matches_jax():
    terms = ["a", "b", "a", "a", "c", "b", ["x", "y"], ["x", "y"]]
    for fun in (None, lambda x: x * 10):
        assert TermFrequency(fun).apply(terms) == JTermFrequency(fun).apply(terms)


def test_common_and_all_sparse_features_match_jax():
    docs = [[("x", 1.0), ("y", 2.0)], [("y", 1.0), ("z", 5.0)], [("w", 1.0)]]
    got = CommonSparseFeatures(2).fit(Dataset.from_items(docs))
    want = JCommonSparseFeatures(2).fit(JDataset.from_items(docs))
    assert got.feature_space == want.feature_space == {"y": 0, "x": 1}
    assert got.apply([("z", 9.0), ("y", 4.0), ("x", 3.0)]) == [(0, 4.0), (1, 3.0)]
    _assert_same_rows(got.apply_batch(Dataset.from_items(docs)).payload,
                      want.apply_batch(JDataset.from_items(docs)).payload)
    docs = [[("b", 1.0)], [("a", 1.0), ("b", 2.0)], [("c", 3.0)]]
    assert (AllSparseFeatures().fit(Dataset.from_items(docs)).feature_space
            == JAllSparseFeatures().fit(JDataset.from_items(docs)).feature_space
            == {"b": 0, "a": 1, "c": 2})


# ---- indexers ------------------------------------------------------------------

def test_bitpack_indexer_matches_jax():
    from keystone_tpu.nodes.nlp.indexers import NaiveBitPackIndexer as J

    assert NaiveBitPackIndexer.pack([1, 1, 1]) == 1 + 2 ** 40 + 2 ** 20 + 2 ** 61
    rng = np.random.default_rng(0)
    for order in (1, 2, 3):
        words = rng.integers(0, 2 ** 20, size=(100, order))
        packed = NaiveBitPackIndexer.pack_batch(words, order)
        np.testing.assert_array_equal(packed, J.pack_batch(words, order))
        np.testing.assert_array_equal(packed, [NaiveBitPackIndexer.pack(list(w)) for w in words])
        unpacked, orders = NaiveBitPackIndexer.unpack_batch(packed)
        assert np.all(orders == order)
        np.testing.assert_array_equal(unpacked[:, :order], words)
        if order > 1:
            o = np.full(100, order)
            np.testing.assert_array_equal(NaiveBitPackIndexer.remove_current_word_batch(packed, o),
                                          J.remove_current_word_batch(packed, o))
            np.testing.assert_array_equal(
                NaiveBitPackIndexer.remove_farthest_word_batch(packed, o),
                J.remove_farthest_word_batch(packed, o))
    with pytest.raises(ValueError):
        NaiveBitPackIndexer.pack([-1, 2])


@pytest.mark.parametrize("indexer", [NaiveBitPackIndexer, NGramIndexerImpl])
def test_indexers_remove_words(indexer):
    assert indexer.remove_farthest_word(indexer.pack([1, 2, 3])) == indexer.pack([2, 3])
    assert indexer.remove_farthest_word(indexer.pack([1, 2])) == indexer.pack([2])
    assert indexer.remove_current_word(indexer.pack([1, 2, 3])) == indexer.pack([1, 2])
    assert indexer.remove_current_word(indexer.pack([1, 2])) == indexer.pack([1])


# ---- Stupid Backoff ------------------------------------------------------------

def _lm(pkg_nlp, data_cls):
    tok = pkg_nlp.Tokenizer()
    docs = [tok.apply(d) for d in ["Winter is coming", "Finals are coming",
                                   "Summer is coming really soon"]]
    ngrams = pkg_nlp.NGramsCounts("noadd").apply_batch(
        data_cls.from_items([pkg_nlp.NGramsFeaturizer(list(range(2, 6))).apply(d) for d in docs]))
    unigrams = {g[0]: c for g, c in pkg_nlp.NGramsCounts().apply_batch(
        data_cls.from_items([pkg_nlp.NGramsFeaturizer([1]).apply(d) for d in docs])).collect()}
    return pkg_nlp.StupidBackoffEstimator(unigrams).fit(ngrams)


def test_stupid_backoff_scores_match_jax():
    lm, jlm = _lm(nlp, Dataset), _lm(jnlp, JDataset)
    assert lm.scores == jlm.scores
    assert lm.score(("is", "coming")) == 1.0
    assert lm.score(("is", "coming", "really")) == 0.5
    assert lm.score(("is", "unseen-coming")) == 0.0
    assert lm.score(("is-unseen", "coming")) == lm.alpha * 3.0 / lm.num_tokens
    assert all(0.0 <= s <= 1.0 for s in lm.scores.values())
    with pytest.raises(ValueError):
        PackedStupidBackoffModel.from_model(lm)  # orders above 3


def test_packed_stupid_backoff_matches_the_dict_form_and_jax():
    lm = sbp.train_language_model(sbp.synthetic_corpus(80, seed=3), n=3)
    jlm = jsbp.train_language_model(jsbp.synthetic_corpus(80, seed=3), n=3)
    assert lm.scores == jlm.scores and lm.num_tokens == jlm.num_tokens
    packed = PackedStupidBackoffModel.from_model(lm)
    vocab = sorted(lm.unigram_counts)
    hi = max(vocab) + 7
    queries = list(lm.ngram_counts) + [(v,) for v in vocab[:5]] + [
        (hi,), (hi, vocab[0]), (vocab[0], hi), (hi, hi + 1, hi + 2), (hi, vocab[0], vocab[1])]
    want = np.asarray([lm.score(q) for q in queries])
    np.testing.assert_array_equal(packed.score_batch(queries), want)
    np.testing.assert_array_equal(
        packed.score_batch(queries),
        jsb.PackedStupidBackoffModel.from_model(jlm).score_batch(queries))


def test_packed_stupid_backoff_corners():
    lm = StupidBackoffModel({}, {(1, 2): 4, (2,): 7}, {1: 10, 2: 3}, 13)
    packed = PackedStupidBackoffModel.from_model(lm)
    for q in [(99, 2), (2,), (1, 2), (99,)]:
        assert packed.score(q) == lm.score(q), q
    empty = PackedStupidBackoffModel(*(np.zeros(0, np.int64),) * 4, num_tokens=1)
    assert empty.score((3, 4)) == 0.0
    with pytest.raises(ZeroDivisionError):
        PackedStupidBackoffModel.from_model(StupidBackoffModel({}, {(1, 2): 4}, {2: 3}, 7)).score(
            (1, 2))
    oov = PackedStupidBackoffModel.from_model(
        StupidBackoffModel({}, {(5, 7): 4, (7,): 2}, {5: 3, 7: 6}, 11))
    with pytest.raises(ValueError, match="OOV"):
        oov.score_packed(NaiveBitPackIndexer.pack_batch(np.asarray([[-1, 5, 7]]), 3))


# ---- CoreNLPFeatureExtractor (corenlp_lite): the five assertions of the
# JAX package's tests/nodes/test_corenlp_lite.py, and output equality with
# the JAX node (both are host Python: exact) ----


def test_corenlp_lemmatization():
    tokens = set(nlp.CoreNLPFeatureExtractor(range(1, 4)).apply(
        "jumping snakes lakes oceans hunted"))
    for lemma in ("jump", "snake", "lake", "ocean", "hunt"):
        assert lemma in tokens
    for raw in ("jumping", "snakes", "lakes", "oceans", "hunted"):
        assert raw not in tokens


def test_corenlp_entity_extraction():
    tokens = set(nlp.CoreNLPFeatureExtractor(range(1, 4)).apply(
        "John likes cake and he lives in Florida"))
    assert "PERSON" in tokens and "LOCATION" in tokens
    assert not {"John", "john", "Florida", "florida"} & tokens


def test_corenlp_1_2_3_grams():
    tokens = set(nlp.CoreNLPFeatureExtractor(range(1, 4)).apply("a b c d"))
    assert {"a", "b", "c", "d"} <= tokens
    assert {"a b", "b c", "c d"} <= tokens
    assert {"a b c", "b c d"} <= tokens


def test_corenlp_grams_respect_sentence_boundaries():
    tokens = nlp.CoreNLPFeatureExtractor([2]).apply("a b. c d")
    assert "b c" not in tokens
    assert "a b" in tokens and "c d" in tokens


def test_corenlp_lemmatizer_rules():
    for word, lemma in (("running", "run"), ("making", "make"), ("cities", "city"),
                        ("children", "child"), ("glasses", "glass"), ("sing", "sing")):
        assert nlp.lemmatize(word) == lemma == jnlp.corenlp_lite.lemmatize(word)


@pytest.mark.parametrize("orders", [[1], [2, 3], range(1, 4)])
def test_corenlp_extractor_equals_jax_on_a_corpus(orders):
    from keystone_tpu.nodes.nlp.corenlp_lite import CoreNLPFeatureExtractor as JCoreNLP

    corpus = [
        "Mary went to Paris. She was making plans! The children ran home?",
        "John and Sarah stopped running in Texas; cities were buzzing... Hoped it rained.",
        "Geese, mice and women said nothing. 42 glasses broke at 3pm in Boston!!",
        "", "   ", "A b. C d. e",
    ]
    for doc in corpus:
        assert nlp.CoreNLPFeatureExtractor(orders).apply(doc) == JCoreNLP(orders).apply(doc)
