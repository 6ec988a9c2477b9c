"""The three text applications of the port end to end on the CPU, at the JAX
tests' sizes (``tests/pipelines/test_text_pipelines.py``), against the JAX
package on the same corpora:

* NewsgroupsPipeline: the same selected features and test predictions as
  the JAX pipeline (naive Bayes on integer term counts;
  θ within 1e-6), test error < 0.15 as the JAX test asks; per-item apply equals the
  batch; the on-disk loader path;
* AmazonReviewsPipeline: predictions equal to the JAX pipeline's (W of the
  logistic regression within rtol 1e-3 / atol 1e-4), accuracy > 0.9;
* StupidBackoffPipeline: the same scores as the JAX model, the JAX test's
  checks;
* the plans: no fused group in either fitted graph; where a later optimize
  fuses NaiveBayesModel with MaxClassifier, the SparseRows batch runs that
  group step by step (the JAX package's fused group cannot trace it) and
  answers as the fitted chain does;
* the command lines, which refuse to run on the CPU unless asked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.loaders import text as jtext
from keystone_tpu.pipelines import amazon_reviews as jam
from keystone_tpu.pipelines import newsgroups as jng
from keystone_tpu.pipelines import stupid_backoff_pipeline as jsbp
from keystone_tpu.workflow.env import PipelineEnv as JPipelineEnv
from keystone_tpu_torch import __main__ as cli
from keystone_tpu_torch.data.sparse import SparseRows
from keystone_tpu_torch.loaders import text as text_loaders
from keystone_tpu_torch.nodes.learning.classifiers import NaiveBayesModel
from keystone_tpu_torch.nodes.nlp.packed_features import PackedTextVectorizer
from keystone_tpu_torch.pipelines import amazon_reviews as am
from keystone_tpu_torch.pipelines import newsgroups as ng
from keystone_tpu_torch.pipelines import stupid_backoff_pipeline as sbp
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.fusion import FusedTransformerOperator, TraceFusionRule
from keystone_tpu_torch.workflow.graph import NodeId

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    JPipelineEnv.get_or_create().reset()
    yield env
    env.reset()
    JPipelineEnv.get_or_create().reset()


def _chain(graph):
    names, gid = [], graph.get_sink_dependency(next(iter(graph.sinks)))
    while isinstance(gid, NodeId):
        names.append(graph.get_operator(gid))
        (gid,) = graph.get_dependencies(gid)
    return names[::-1]


def _op(fitted, cls):
    (op,) = [o for o in fitted.graph.operators.values() if isinstance(o, cls)]
    return op


# ---- NewsgroupsPipeline ------------------------------------------------------

def test_newsgroups_pipeline_matches_jax():
    train = ng.synthetic_newsgroups(256, num_classes=6, seed=1)
    test = ng.synthetic_newsgroups(96, num_classes=6, seed=2)
    jtrain = jng.synthetic_newsgroups(256, num_classes=6, seed=1)
    jtest = jng.synthetic_newsgroups(96, num_classes=6, seed=2)
    assert train.data.collect() == jtrain.data.collect()
    np.testing.assert_array_equal(train.labels.to_array().numpy(),
                                  np.asarray(jtrain.labels.to_array()))
    conf = ng.NewsgroupsConfig(n_grams=2, common_features=2000, num_classes=6)
    timings = {}
    predictor, evaluation, _ = ng.run(train, test, conf, CPU, timings)
    jpred, jeval, _ = jng.run(jtrain, jtest, jng.NewsgroupsConfig(n_grams=2,
                                                                   common_features=2000,
                                                                   num_classes=6))
    assert evaluation.total_error < 0.15, evaluation.summary()
    assert evaluation.total_error == jeval.total_error
    np.testing.assert_array_equal(evaluation.confusion_matrix, jeval.confusion_matrix)
    assert {"optimize", "featurize", "PackedTextFeatures", "NaiveBayesEstimator", "apply",
            "evaluate"} <= set(timings)

    fitted, jfitted = predictor.fit(), jpred.fit()
    vec, jvec = _op(fitted, PackedTextVectorizer), next(
        o for o in jfitted.graph.operators.values() if type(o).__name__ == "PackedTextVectorizer")
    np.testing.assert_array_equal(vec.selected, jvec.selected)
    nb = _op(fitted, NaiveBayesModel)
    jnb = next(o for o in jfitted.graph.operators.values() if type(o).__name__ == "NaiveBayesModel")
    np.testing.assert_allclose(nb.theta.numpy(), np.asarray(jnb.theta), rtol=1e-6, atol=1e-6)
    preds = fitted.apply(test.data).to_array().numpy()
    np.testing.assert_array_equal(preds, np.asarray(jpred(jtest.data).get().to_array()))


def test_newsgroups_per_datum_apply_equals_the_batch():
    train = ng.synthetic_newsgroups(128, num_classes=4, seed=9)
    conf = ng.NewsgroupsConfig(n_grams=2, common_features=800, num_classes=4)
    predictor = ng.build_predictor(train.data, train.labels, conf, CPU)
    batch_preds = predictor(train.data).get().to_array().numpy()
    docs = train.data.collect()
    for i in (0, 5, 17):
        assert int(predictor.apply_datum(docs[i]).get()) == batch_preds[i]


def test_newsgroups_loader_and_pipeline_from_dirs(tmp_path):
    data = ng.synthetic_newsgroups(60, num_classes=2, seed=3)
    classes = ["comp.graphics", "comp.os.ms-windows.misc"]
    for split in ("train", "test"):
        for c in classes:
            os.makedirs(tmp_path / split / c, exist_ok=True)
    labels = data.labels.to_array().numpy()
    for i, (doc, lab) in enumerate(zip(data.data.collect(), labels)):
        split = "train" if i < 40 else "test"
        (tmp_path / split / classes[lab] / f"{i}.txt").write_text(doc)
    train = text_loaders.load_newsgroups(str(tmp_path / "train"))
    test = text_loaders.load_newsgroups(str(tmp_path / "test"))
    jtrain = jtext.load_newsgroups(str(tmp_path / "train"))
    assert len(train.data) == 40 and len(test.data) == 20
    assert train.data.collect() == jtrain.data.collect()
    np.testing.assert_array_equal(train.labels.to_array().numpy(),
                                  np.asarray(jtrain.labels.to_array()))
    assert text_loaders.NEWSGROUPS_CLASSES == jtext.NEWSGROUPS_CLASSES
    conf = ng.NewsgroupsConfig(n_grams=1, common_features=500, num_classes=2)
    _, evaluation, _ = ng.run(train, test, conf, CPU)
    assert evaluation.total_error < 0.25


# ---- AmazonReviewsPipeline ---------------------------------------------------

def test_amazon_reviews_pipeline_matches_jax():
    train, test = am.synthetic_reviews(256, seed=1), am.synthetic_reviews(96, seed=2)
    jtrain, jtest = jam.synthetic_reviews(256, seed=1), jam.synthetic_reviews(96, seed=2)
    assert test.data.collect() == jtest.data.collect()
    conf = am.AmazonReviewsConfig(n_grams=2, common_features=2000, num_iters=30)
    predictor, evaluation, _ = am.run(train, test, conf, CPU)
    jpred, jeval, _ = jam.run(jtrain, jtest, jam.AmazonReviewsConfig(
        n_grams=2, common_features=2000, num_iters=30))
    assert evaluation.accuracy > 0.9, evaluation.summary()
    assert (evaluation.tp, evaluation.fp, evaluation.tn, evaluation.fn) == (
        jeval.tp, jeval.fp, jeval.tn, jeval.fn)
    fitted, jfitted = predictor.fit(), jpred.fit()
    lr = next(o for o in fitted.graph.operators.values()
              if type(o).__name__ == "LogisticRegressionModel")
    jlr = next(o for o in jfitted.graph.operators.values()
               if type(o).__name__ == "LogisticRegressionModel")
    np.testing.assert_allclose(lr.W.numpy(), np.asarray(jlr.W), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(fitted.apply(test.data).to_array().numpy(),
                                  np.asarray(jpred(jtest.data).get().to_array()))


def test_amazon_loader_matches_jax(tmp_path):
    recs = [{"overall": 5.0, "reviewText": "great product love it"},
            {"overall": 1.0, "reviewText": "terrible broken refund"},
            {"overall": 4.0, "reviewText": "pretty good"},
            {"overall": 2.0, "reviewText": "not great"}, {"overall": 3.5}]
    path = tmp_path / "reviews.json"
    path.write_text("".join(json.dumps(r) + "\n\n" for r in recs))
    got = text_loaders.load_amazon_reviews(str(path), threshold=3.5)
    want = jtext.load_amazon_reviews(str(path), threshold=3.5)
    assert got.labels.to_array().tolist() == [1, 0, 1, 0, 1]
    assert got.data.collect() == want.data.collect()
    assert got.data.collect()[0] == "great product love it" and got.data.collect()[4] == ""


# ---- StupidBackoffPipeline ---------------------------------------------------

def test_stupid_backoff_pipeline_matches_jax():
    lm = sbp.train_language_model(sbp.synthetic_corpus(100, seed=4), n=3)
    jlm = jsbp.train_language_model(jsbp.synthetic_corpus(100, seed=4), n=3)
    assert lm.num_tokens == jlm.num_tokens > 0
    assert lm.scores == jlm.scores and len(lm.scores) > 0
    assert all(0.0 <= s <= 1.0 for s in lm.scores.values())
    some_bigram = next(g for g in lm.scores if len(g) == 2)
    assert lm.score(some_bigram) > 0


def test_stupid_backoff_cli(tmp_path, capsys):
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(sbp.synthetic_corpus(30, seed=5)))
    out = cli.run(["StupidBackoffPipeline", "--trainData", str(path), "--n", "2"])
    want = jsbp.train_language_model(jsbp.synthetic_corpus(30, seed=5), n=2)
    assert out["model"].scores == want.scores
    assert cli.main(["StupidBackoffPipeline"]) == 0
    assert "number of tokens:" in capsys.readouterr().out


# ---- the plans ---------------------------------------------------------------

def test_the_fitted_text_graphs_hold_no_fused_group():
    train = ng.synthetic_newsgroups(96, num_classes=4, seed=1)
    test = ng.synthetic_newsgroups(40, num_classes=4, seed=2)
    nfit = ng.build_predictor(train.data, train.labels,
                              ng.NewsgroupsConfig(common_features=300, num_classes=4), CPU).fit()
    reviews = am.synthetic_reviews(96, seed=1)
    afit = am.build_predictor(reviews.data, reviews.labels,
                              am.AmazonReviewsConfig(common_features=300), CPU).fit()
    assert [type(o).__name__ for o in _chain(nfit.graph)] == [
        "PackedTextVectorizer", "NaiveBayesModel", "MaxClassifier"]
    assert [type(o).__name__ for o in _chain(afit.graph)] == [
        "PackedTextVectorizer", "LogisticRegressionModel"]
    # a later optimize of the fitted Newsgroups chain fuses the two dense
    # steps; Amazon's lone model has nothing to fuse with
    fused, _ = TraceFusionRule().apply(nfit.graph, {})
    groups = [[op.label for op, _ in o.steps] for o in fused.operators.values()
              if isinstance(o, FusedTransformerOperator)]
    assert groups == [["NaiveBayesModel", "MaxClassifier"]]
    afused, _ = TraceFusionRule().apply(afit.graph, {})
    assert not any(isinstance(o, FusedTransformerOperator) for o in afused.operators.values())
    # that group reads the SparseRows batch step by step and answers alike
    want = nfit.apply(test.data).to_array()
    got = nfit.to_pipeline()(test.data).get().to_array()
    assert torch.equal(got, want)


def test_the_training_corpus_is_featurized_once(monkeypatch):
    calls = []
    orig = PackedTextVectorizer._vectorize

    def counting(self, docs, precomputed=None):
        calls.append(precomputed is not None)
        return orig(self, docs, precomputed)

    monkeypatch.setattr(PackedTextVectorizer, "_vectorize", counting)
    train = ng.synthetic_newsgroups(80, num_classes=3, seed=1)
    predictor = ng.build_predictor(train.data, train.labels,
                                   ng.NewsgroupsConfig(common_features=300, num_classes=3), CPU)
    fitted = predictor.fit()
    assert calls == [True]  # the training set's rows from the fit's grams
    rows = fitted.seconds
    assert rows["NaiveBayesEstimator"] >= 0.0
    predictor.fit()  # fit-once: nothing featurized again
    assert calls == [True]


# ---- the command lines -------------------------------------------------------

@pytest.mark.parametrize("app,args", [
    ("NewsgroupsPipeline", ["--nTrain", "96", "--nTest", "32", "--commonFeatures", "500"]),
    ("AmazonReviewsPipeline", ["--nTrain", "96", "--nTest", "32", "--numIters", "10"]),
])
def test_text_clis_on_the_cpu(app, args, capsys):
    out = cli.run([app, "--device", "cpu", *args])
    assert out["seconds"] > 0 and out["phases"]["draw"] >= 0
    key = "test_error" if app == "NewsgroupsPipeline" else "accuracy"
    assert 0.0 <= out[key] <= 1.0
    assert cli.main([app, "--device", "cpu", *args]) == 0
    assert "Pipeline took" in capsys.readouterr().out


@pytest.mark.parametrize("app", ["NewsgroupsPipeline", "AmazonReviewsPipeline"])
def test_text_clis_without_device_cpu_do_not_run_on_the_cpu(app):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", app, "--nTrain", "16",
                           "--nTest", "8"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Pipeline took" not in proc.stdout


def test_sparse_rows_reach_the_model_once_per_dataset():
    train = am.synthetic_reviews(64, seed=1)
    fitted = am.build_predictor(train.data, train.labels,
                                am.AmazonReviewsConfig(common_features=300, num_iters=5),
                                CPU).fit()
    rows = _op(fitted, PackedTextVectorizer).apply_batch(train.data).payload
    assert isinstance(rows, SparseRows) and rows.indices.dtype == torch.int64
