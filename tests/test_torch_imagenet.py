"""ImageNetSiftLcsFV against the JAX package on the CPU, at the JAX test's
small configuration (16 classes, 48-px images, 96 / 48 of them, descDim
16, vocabSize 4, λ 1e-4):

* the synthetic generators equal JAX's bit for bit;
* the load path: each branch's PCA and GMM fitted once by JAX, written as
  the CLI's CSV files and loaded by both packages. The Fisher vectors
  agree within 1e-3 relative to their largest magnitude (a SIFT entry can
  round across a quantization step; the card test holds that share), the
  weighted model's W within 1e-3 relative, and the top-5 indices are equal
  on every row whose 5th and 6th JAX scores are more than 1e-4 (relative)
  apart;
* carried weights: the JAX fit's arrays through ``fitted_from_arrays``,
  scores within 1e-3 relative of their largest magnitude, top-5 as above;
* the port's own fit: the JAX test's bound (top-5 error < 25 %) and its
  calibrated gate (top-1 within [0.5, 2.5] × the Bayes error, raw pixels
  near chance, and a SIFT with its orientation bins averaged away fails
  the gate);
* TopKClassifier's ties (lower index first, as ``jax.lax.top_k``),
  Shuffler, FloatToDouble and DoubleToFloat, the binary evaluator and the
  top-k error against the JAX oracle;
* the command line on the CPU, on a PIL-written tar of class directories
  too; its synthetic images are 64 px whatever ``--imageSize`` says, as
  the JAX CLI's."""

import io
import subprocess
import sys
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.evaluation.binary import BinaryClassifierEvaluator as JBinary
from keystone_tpu.nodes.images import GrayScaler as JGray
from keystone_tpu.nodes.images import LCSExtractor as JLCS
from keystone_tpu.nodes.images import PixelScaler as JPixel
from keystone_tpu.nodes.images import SIFTExtractor as JSIFT
from keystone_tpu.nodes.images.fisher_vector import GMMFisherVectorEstimator as JGMMFV
from keystone_tpu.nodes.learning import BatchPCATransformer as JBatchPCA
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
from keystone_tpu.nodes.learning.pca import LocalColumnPCAEstimator as JLocalPCA
from keystone_tpu.nodes.stats import ColumnSampler as JSampler
from keystone_tpu.nodes.stats import SignedHellingerMapper as JSH
from keystone_tpu.nodes.util import Cacher as JCacher
from keystone_tpu.nodes.util import Shuffler as JShuffler
from keystone_tpu.pipelines import imagenet_sift_lcs_fv as jin
from keystone_tpu.workflow.pipeline import FittedPipeline as JFitted
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.evaluation.binary import BinaryClassifierEvaluator
from keystone_tpu_torch.nodes.images.sift import SIFTExtractor, num_descriptors
from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
from keystone_tpu_torch.nodes.util import DoubleToFloat, FloatToDouble, Shuffler, TopKClassifier
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as tin
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.pipeline import FittedPipeline

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CLASSES, SIZE, DESC_DIM, VOCAB, LAM = 16, 48, 16, 4, 1e-4
SAMPLES = 20_000


@pytest.fixture(autouse=True)
def port_env():
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


@pytest.fixture(scope="module")
def data():
    tr_i, tr_l = jin.synthetic_imagenet(96, CLASSES, size=SIZE, seed=1)
    te_i, te_l = jin.synthetic_imagenet(48, CLASSES, size=SIZE, seed=2)
    return tr_i, tr_l, te_i, te_l


def _cut(fitted, fitted_cls, cls_name: str, up: int):
    """``fitted`` ending at the node of class ``cls_name``'s input (``up``
    1) or output (``up`` 0)."""
    g = fitted.graph
    node = next(n for n in g.nodes if type(g.get_operator(n)).__name__ == cls_name)
    if up:
        node = g.get_dependencies(node)[0]
    g2, sink = g.add_sink(node)
    return fitted_cls(g2, fitted._source, sink)


@pytest.fixture(scope="module")
def jax_fit(data, tmp_path_factory):
    """Each branch's PCA and GMM as the JAX package's ``run`` fits them
    (with the local column PCA), written as CSV files; then the JAX
    predictor fitted through those files: its arrays, its test features,
    scores and top-5."""
    tr_i, tr_l, te_i, _ = data
    per_img = SAMPLES // len(tr_i)
    folder = tmp_path_factory.mktemp("imagenet_files")
    conf_files, params = {}, {}
    prefixes = {"sift": JPixel().and_then(JGray()).and_then(JSIFT(scale_step=1))
                .and_then(JSH()).and_then(JCacher()),
                "lcs": JLCS(4, 16, 6).to_pipeline().and_then(JCacher())}
    for (name, prefix), seed in zip(prefixes.items(), (0, 17)):
        descs = prefix(tr_i).get()
        pca = JLocalPCA(DESC_DIM).fit(JSampler(per_img, seed=seed).apply_batch(descs))
        gmm_sample = JBatchPCA(pca.pca_mat).apply_batch(
            JSampler(per_img, seed=seed + 1).apply_batch(descs))
        gmm = JGMMFV(VOCAB, max_iterations=20, min_cluster_size=1).fit(gmm_sample).gmm
        for key, arr in (("pca", np.asarray(pca.pca_mat).T), ("gmm_mean", gmm.means),
                         ("gmm_var", gmm.variances), ("gmm_wts", gmm.weights)):
            path = folder / f"{name}_{key}.csv"
            np.savetxt(path, np.asarray(arr, np.float64), delimiter=",", fmt="%.9e")
            conf_files[f"{name}_{key}_file"] = str(path)
        params.update({f"{name}_pca_mat": np.asarray(pca.pca_mat),
                       f"{name}_gmm_means": np.asarray(gmm.means),
                       f"{name}_gmm_variances": np.asarray(gmm.variances),
                       f"{name}_gmm_weights": np.asarray(gmm.weights)})
    conf = jin.ImageNetSiftLcsFVConfig(desc_dim=DESC_DIM, vocab_size=VOCAB,
                                       num_classes=CLASSES, lam=LAM, **conf_files)
    fitted = jin.build_predictor(tr_i, tr_l, conf).fit()
    mapper = next(op for op in fitted.graph.operators.values() if isinstance(op, JBlockMapper))
    params.update(W=[np.asarray(x) for x in mapper.xs], b=np.asarray(mapper.b))
    te = JDataset.of(jnp.asarray(te_i))
    return {"files": conf_files, "params": params,
            "features": np.asarray(_cut(fitted, JFitted, "BlockLinearMapper", 1)
                                   .apply(te).to_array()),
            "scores": np.asarray(_cut(fitted, JFitted, "BlockLinearMapper", 0)
                                 .apply(te).to_array()),
            "top5": np.asarray(fitted.apply(te).to_array())}


def _separated_rows(scores, rel=1e-4):
    """Rows whose 5th and 6th largest scores differ by more than ``rel`` of
    the largest magnitude: there the top-5 set is not decided by rounding."""
    s = -np.sort(-scores, axis=1)
    return (s[:, 4] - s[:, 5]) > rel * np.abs(scores).max()


def _same_top5(got, want_top5, want_scores):
    rows = _separated_rows(want_scores)
    assert rows.mean() > 0.9, rows.mean()
    np.testing.assert_array_equal(np.asarray(got)[rows], want_top5[rows])


def test_generators_equal_jax():
    for got, want in zip(tin.synthetic_imagenet(6, 12, size=40, seed=3),
                         jin.synthetic_imagenet(6, 12, size=40, seed=3)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    kw = dict(num_classes=100, size=40, theta_sigma=0.09, logf_sigma=0.03, n_theta=5,
              f_range=(0.06, 0.45), seed=9)
    got, want = tin.synthetic_gradient_imagenet(5, **kw), jin.synthetic_gradient_imagenet(5, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    got, want = tin.synthetic_gradient_imagenet(4, 16, seed=1), jin.synthetic_gradient_imagenet(
        4, 16, seed=1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2]


def test_load_path_matches_jax(data, jax_fit):
    tr_i, tr_l, te_i, te_l = data
    conf = tin.ImageNetSiftLcsFVConfig(desc_dim=DESC_DIM, vocab_size=VOCAB, num_classes=CLASSES,
                                       lam=LAM, **jax_fit["files"])
    details = {}
    fitted, err, _ = tin.run(tr_i, tr_l, te_i, te_l, conf, CPU, details)
    assert details["fv_width"] == 2 * 2 * DESC_DIM * VOCAB
    assert details["solver_path"] == "dual"  # 96 + 3 < 256
    assert details["block_steps"] == 1 and details["class_chunks"] == 1
    assert "sift" not in details["phases"] and "samples" not in details["phases"]
    features = _cut(fitted, FittedPipeline, "BlockLinearMapper", 1).apply(
        torch.from_numpy(te_i)).to_array().numpy()
    want = jax_fit["features"]
    np.testing.assert_allclose(features, want, rtol=0, atol=1e-3 * np.abs(want).max())
    mapper = next(op for op in fitted.graph.operators.values() if isinstance(op, BlockLinearMapper))
    W = np.concatenate(jax_fit["params"]["W"])
    np.testing.assert_allclose(mapper._W.numpy(), W, rtol=0, atol=1e-3 * np.abs(W).max())
    _same_top5(details["top5"].numpy(), jax_fit["top5"], jax_fit["scores"])
    np.testing.assert_array_equal(fitted.apply(torch.from_numpy(te_i)).to_array().numpy(),
                                  details["top5"].numpy())
    assert err == pytest.approx(jin.top_k_err_percent(details["top5"].numpy(), te_l))


def test_fitted_from_arrays_matches_the_jax_pipeline(data, jax_fit):
    _, _, te_i, _ = data
    conf = tin.ImageNetSiftLcsFVConfig(desc_dim=DESC_DIM, vocab_size=VOCAB, num_classes=CLASSES)
    X = torch.from_numpy(te_i)
    scores = tin.fitted_from_arrays(jax_fit["params"], conf, CPU, classify=False).apply(
        X).to_array().numpy()
    want = jax_fit["scores"]
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-3 * np.abs(want).max())
    fitted = tin.fitted_from_arrays(jax_fit["params"], conf, CPU)
    assert [type(op).__name__ for op in fitted.graph.operators.values()] == [
        "FusedTransformerOperator", "BlockLinearMapper", "TopKClassifier"]
    _same_top5(fitted.apply(X).to_array().numpy(), jax_fit["top5"], want)


def test_fitted_by_the_port(data):
    """The JAX test's end-to-end bound, on the port's own fit: PCA, k-means++
    seeding (the port's own draws) and EM of both branches, then the dual
    path of the weighted solver."""
    tr_i, tr_l, te_i, te_l = data
    conf = tin.ImageNetSiftLcsFVConfig(desc_dim=DESC_DIM, vocab_size=VOCAB,
                                       num_pca_samples=SAMPLES, num_gmm_samples=SAMPLES,
                                       num_classes=CLASSES, lam=LAM)
    details = {}
    fitted, err, _ = tin.run(tr_i, tr_l, te_i, te_l, conf, CPU, details)
    assert err < 25.0, f"top-5 error {err}%"
    assert details["top5"].shape == (48, 5)
    assert details["descriptors"] == {"sift": num_descriptors(SIZE, SIZE, scale_step=1),
                                      "lcs": tin.LCSExtractor(4, 16, 6).num_descriptors(SIZE, SIZE)}
    assert set(details["phases"]) >= {"data", "sift", "lcs", "samples", "pca_fit", "gmm",
                                      "featurize", "solve", "apply", "evaluate"}
    assert all(1 <= it <= 20 for it in details["em_iterations"].values())
    # the pixels-to-FV featurizer of both branches is one fused group
    names = sorted(type(op).__name__ for op in fitted.graph.operators.values())
    assert names == ["BlockLinearMapper", "FusedTransformerOperator", "TopKClassifier"]


def test_calibrated_gate_and_broken_sift_control(monkeypatch):
    """The JAX test's calibrated gate on the port's fit: top-1 within [0.5,
    2.5] × the task's Bayes error; raw pixels through an exact ridge (λ 10,
    in its dual form) well above it; and a SIFT whose 8 orientation bins
    are averaged away fails the gate."""
    from keystone_tpu_torch.nodes.learning.lbfgs import LocalLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicators

    gen = dict(num_classes=16, size=48, theta_sigma=0.12, logf_sigma=0.10)
    tr_i, tr_l, bayes = tin.synthetic_gradient_imagenet(256, seed=1, **gen)
    te_i, te_l, _ = tin.synthetic_gradient_imagenet(128, seed=2, **gen)
    conf = tin.ImageNetSiftLcsFVConfig(desc_dim=16, vocab_size=8, num_pca_samples=40_000,
                                       num_gmm_samples=40_000, num_classes=16, lam=1e-4)
    gate = 2.5 * bayes
    details = {}
    tin.run(tr_i, tr_l, te_i, te_l, conf, CPU, details)
    top1 = 100.0 * float((details["top5"][:, 0].numpy() != te_l).mean())
    assert 0.5 * bayes <= top1 <= gate, (top1, bayes)

    Xtr = torch.from_numpy(tr_i.reshape(len(tr_i), -1).astype(np.float32) / 255.0)
    Xte = torch.from_numpy(te_i.reshape(len(te_i), -1).astype(np.float32) / 255.0)
    Y = ClassLabelIndicators(16).forward(torch.from_numpy(tr_l))
    raw = LocalLeastSquaresEstimator(lam=10.0).fit(Dataset.of(Xtr), Dataset.of(Y))
    raw_err = 100.0 * float((raw.forward(Xte).argmax(dim=1).numpy() != te_l).mean())
    assert raw_err > 2 * top1 and raw_err > 40.0, (raw_err, top1)

    forward = SIFTExtractor.forward

    def broken(self, X):
        D = forward(self, X)
        n, d, m = D.shape
        D4 = D.reshape(n, d // 8, 8, m)
        return D4.mean(dim=2, keepdim=True).expand(D4.shape).reshape(n, d, m)

    monkeypatch.setattr(SIFTExtractor, "forward", broken)
    PipelineEnv.get_or_create().reset()
    details = {}
    tin.run(tr_i, tr_l, te_i, te_l, conf, CPU, details)
    broken_err = 100.0 * float((details["top5"][:, 0].numpy() != te_l).mean())
    assert broken_err > gate, (broken_err, gate)


def test_top_k_err_percent_oracle():
    topk = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    actual = np.array([1, 9, 8])  # hit, miss, hit
    assert abs(tin.top_k_err_percent(topk, actual) - 100.0 / 3.0) < 1e-9
    assert tin.top_k_err_percent(topk, actual) == jin.top_k_err_percent(topk, actual)


def test_top_k_classifier_breaks_ties_as_jax():
    X = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [5.0, 4.0, 3.0, 2.0, 1.0, 0.0],
                  [-1.0, 2.0, 2.0, -1.0, 7.0, 2.0]], dtype=np.float32)
    rng = np.random.default_rng(0)
    X = np.concatenate([X, rng.integers(0, 4, (32, 6)).astype(np.float32)])
    for k in (1, 3, 5):
        got = TopKClassifier(k).forward(torch.from_numpy(X)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.lax.top_k(jnp.asarray(X), k)[1]))
    np.testing.assert_array_equal(TopKClassifier(3).apply(torch.from_numpy(X[0])).numpy(),
                                  [1, 2, 4])


def test_shuffler_and_dtype_nodes_match_jax():
    X = np.arange(30, dtype=np.float32).reshape(10, 3)
    got = Shuffler(seed=5).apply_batch(Dataset.of(torch.from_numpy(X))).to_array().numpy()
    want = np.asarray(JShuffler(seed=5).apply_batch(JDataset.of(jnp.asarray(X))).to_array())
    np.testing.assert_array_equal(got, want)
    items = Shuffler(seed=5).apply_batch(Dataset.from_items(list("abcdefghij"))).collect()
    assert items == JShuffler(seed=5).apply_batch(JDataset.from_items(list("abcdefghij"))).collect()
    wide = FloatToDouble().forward(torch.from_numpy(X))
    assert wide.dtype == torch.float64
    back = DoubleToFloat().forward(wide)
    assert back.dtype == torch.float32 and torch.equal(back, torch.from_numpy(X))


def test_binary_evaluator_matches_jax():
    rng = np.random.default_rng(1)
    pred, act = rng.random(200) > 0.4, rng.random(200) > 0.5
    got = BinaryClassifierEvaluator().evaluate(torch.from_numpy(pred), act)
    want = JBinary().evaluate(pred, act)
    for field in ("tp", "fp", "tn", "fn", "accuracy", "error", "recall", "precision",
                  "specificity"):
        assert getattr(got, field) == getattr(want, field)
    assert got.f_score(0.5) == want.f_score(0.5) and got.summary() == want.summary()
    merged = got.merge(got)
    assert (merged.tp, merged.fn) == (2 * got.tp, 2 * got.fn)
    with pytest.raises(ValueError):
        BinaryClassifierEvaluator().evaluate(pred[:5], act)


def test_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "ImageNetSiftLcsFV", "--device", "cpu",
         "--nTrain", "32", "--nTest", "16", "--numClasses", "8", "--descDim", "8",
         "--vocabSize", "4", "--numPcaSamples", "5000", "--numGmmSamples", "5000"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "TEST Error is" in proc.stdout and "Pipeline took" in proc.stdout


def test_cli_synthetic_images_are_64_px_whatever_image_size_says():
    out = tin.run_app(["ImageNetSiftLcsFV", "--device", "cpu", "--imageSize", "256",
                       "--nTrain", "12", "--nTest", "4", "--numClasses", "6", "--descDim", "4",
                       "--vocabSize", "2", "--numPcaSamples", "2000", "--numGmmSamples", "2000"])
    assert out["details"]["descriptors"]["sift"] == num_descriptors(64, 64, scale_step=1)
    assert out["details"]["top5"].shape == (4, 5)
    assert out["details"]["fv_width"] == 2 * 2 * 4 * 2



def test_cli_reads_a_tar_of_class_directories(tmp_path):
    """``--trainLocation``: a tar of PNGs under class directories, written
    by PIL, with a labels file; the label space grows to the file's largest
    label, as the JAX CLI's does."""
    from PIL import Image

    imgs, labels = jin.synthetic_imagenet(24, 3, size=56, seed=5)
    (tmp_path / "labels.txt").write_text("c0 0\nc1 1\nc2 19\n")
    with tarfile.open(tmp_path / "train.tar", "w") as tf:
        for i, (img, lab) in enumerate(zip(imgs, labels)):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            info = tarfile.TarInfo(f"c{lab}/img{i}.png")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
    out = tin.run_app(["ImageNetSiftLcsFV", "--device", "cpu", "--trainLocation",
                       str(tmp_path / "train.tar"), "--labelsFile", str(tmp_path / "labels.txt"),
                       "--imageSize", "48", "--numClasses", "8", "--descDim", "4",
                       "--vocabSize", "2", "--numPcaSamples", "2000", "--numGmmSamples", "2000"])
    details = out["details"]
    assert details["descriptors"]["sift"] == num_descriptors(48, 48, scale_step=1)
    assert tuple(details["scores"].shape) == (24, 20)
    assert bool(torch.isfinite(details["scores"]).all())
    assert 0.0 <= out["top5_error"] <= 100.0


# ---- out of core: a ChunkedDataset of training images ------------------------


def _record_sample_chunk(monkeypatch, cls, to_np):
    """Every ``sample_chunk`` call of ``cls``: (seed, chunk index, input
    chunk, sampled columns), as numpy."""
    calls = []
    orig = cls.sample_chunk

    def record(self, X, i):
        out = orig(self, X, i)
        calls.append((self.seed, i, to_np(X), to_np(out)))
        return out

    monkeypatch.setattr(cls, "sample_chunk", record)
    return calls


def test_chunked_samples_are_jax_draws_bit_for_bit(monkeypatch):
    """Each branch draws its PCA and GMM samples in one scan of its chunked
    descriptors, every chunk's columns keyed by (seed, chunk index): the
    port makes the same calls as the JAX package, and on JAX's descriptor
    chunks draws the same values bit for bit."""
    from keystone_tpu.data import ChunkedDataset as JChunked
    from keystone_tpu_torch.data.chunked import ChunkedDataset
    from keystone_tpu_torch.nodes.stats import ColumnSampler

    tr_i, tr_l = jin.synthetic_imagenet(48, 8, size=SIZE, seed=1)
    te_i, te_l = jin.synthetic_imagenet(24, 8, size=SIZE, seed=2)
    kw = dict(desc_dim=8, vocab_size=4, num_pca_samples=SAMPLES, num_gmm_samples=SAMPLES,
              num_classes=8, lam=1e-4)
    port_calls = _record_sample_chunk(monkeypatch, ColumnSampler, lambda t: t.numpy())
    jax_calls = _record_sample_chunk(monkeypatch, JSampler, np.asarray)
    details = {}
    _, err, _ = tin.run(ChunkedDataset.from_array(torch.from_numpy(tr_i), 13), tr_l, te_i,
                        te_l, tin.ImageNetSiftLcsFVConfig(**kw), CPU, details)
    _, jerr, _ = jin.run(JChunked.from_array(tr_i, 13), tr_l, te_i, te_l,
                         jin.ImageNetSiftLcsFVConfig(**kw))
    assert err < 40.0 and jerr < 40.0  # the JAX test's bound
    # SIFT (seeds 0, 1) and LCS (17, 18): 4 chunks of 13, 13, 13, 9 rows each
    assert [(s, i, c[0].shape) for s, i, c, _ in port_calls] == \
        [(s, i, c[0].shape) for s, i, c, _ in jax_calls]
    assert sorted({s for s, *_ in port_calls}) == [0, 1, 17, 18] and len(port_calls) == 16
    per_img = {s: out.shape[2] for s, _, _, out in jax_calls}
    for seed, i, chunk, want in jax_calls:
        got = ColumnSampler(per_img[seed], seed=seed).sample_chunk(torch.from_numpy(np.array(chunk)), i)
        np.testing.assert_array_equal(got.numpy(), want)
    assert details["descriptors"] == {"sift": num_descriptors(SIZE, SIZE, scale_step=1),
                                      "lcs": tin.LCSExtractor(4, 16, 6).num_descriptors(SIZE,
                                                                                         SIZE)}


def _jax_scores(tr, tr_l, te_i, conf):
    fitted = jin.build_predictor(tr, tr_l, conf).fit()
    return np.asarray(_cut(fitted, JFitted, "BlockLinearMapper", 0).apply(
        JDataset.of(jnp.asarray(te_i))).to_array())


@pytest.mark.parametrize("budget", [None, "1"], ids=["cached", "streamed"])
def test_chunked_load_path_matches_jax(data, jax_fit, budget, monkeypatch):
    """The chunked fit on ``ChunkedDataset.from_array(tr_i, 13)`` in both
    packages, each branch's PCA and GMM loaded from the same CSV files:
    under the default budget the Fisher vectors are cached and solved in
    memory (the dual path), under budget 1 they stream (the dense per-class
    LU). Scores within 1e-3 of their largest magnitude, top-5 equal where
    the 5th and 6th scores are apart."""
    from keystone_tpu.data import ChunkedDataset as JChunked
    from keystone_tpu_torch.data.chunked import ChunkedDataset

    if budget:
        monkeypatch.setenv("KEYSTONE_CHUNK_CACHE_BUDGET", budget)
    tr_i, tr_l, te_i, te_l = data
    files = jax_fit["files"]
    conf = tin.ImageNetSiftLcsFVConfig(desc_dim=DESC_DIM, vocab_size=VOCAB, num_classes=CLASSES,
                                       lam=LAM, **files)
    details = {}
    _, err, _ = tin.run(ChunkedDataset.from_array(torch.from_numpy(tr_i), 13), tr_l, te_i, te_l,
                        conf, CPU, details)
    want = _jax_scores(JChunked.from_array(tr_i, 13), tr_l, te_i,
                       jin.ImageNetSiftLcsFVConfig(desc_dim=DESC_DIM, vocab_size=VOCAB,
                                                   num_classes=CLASSES, lam=LAM, **files))
    assert details["solver_path"] == ("dense" if budget else "dual")
    scores = details["scores"].numpy()
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-3 * np.abs(want).max())
    s = -np.sort(-want, axis=1)
    rows = (s[:, 4] - s[:, 5]) > 1e-4 * np.abs(want).max()
    assert rows.mean() > 0.9
    np.testing.assert_array_equal(details["top5"].numpy()[rows],
                                  np.argsort(-want, axis=1, kind="stable")[rows, :5])


def test_device_generator_statistics_and_lineage():
    """``synthetic_imagenet_device`` draws with ``torch.Generator``, not
    ``jax.random``, so it is held by statistics against the numpy
    generator of the same task: label frequencies near uniform, pixel mean
    and std within 2 % and 3 %; and every scan sees the same chunks."""
    n, k, size = 512, 8, 32
    ds, labels = tin.synthetic_imagenet_device(n, k, size=size, chunk_rows=64, seed=5,
                                               device="cpu")
    ref, ref_labels = jin.synthetic_imagenet(n, k, size=size, seed=5)
    first, second = list(ds.chunks()), list(ds.chunks())
    assert len(first) == 8 and all(torch.equal(a, b) for a, b in zip(first, second))
    imgs = torch.cat(first)
    assert imgs.shape == (n, size, size, 3) and imgs.dtype == torch.uint8
    assert labels.dtype == np.int32 and labels.shape == (n,)
    freq = np.bincount(labels, minlength=k) / n
    assert np.all(np.abs(freq - 1 / k) < 4 * np.sqrt((1 / k) * (1 - 1 / k) / n))
    x, r = imgs.float().numpy(), ref.astype(np.float32)
    assert abs(x.mean() - r.mean()) < 0.02 * r.mean(), (x.mean(), r.mean())
    assert abs(x.std() - r.std()) < 0.03 * r.std(), (x.std(), r.std())
    # gray images, as the numpy generator's: the three channels are equal
    np.testing.assert_array_equal(x[..., 0], x[..., 2])
    again, labels_again = tin.synthetic_imagenet_device(n, k, size=size, chunk_rows=64, seed=5,
                                                        device="cpu")
    np.testing.assert_array_equal(labels, labels_again)
    assert torch.equal(next(iter(again.chunks())), first[0])
