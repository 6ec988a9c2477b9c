"""VOCSIFTFisher against the JAX package on the CPU: the image loader on a
tar written by PIL, the pipeline end to end through the load path (the
JAX reference's fitted PCA matrix and GMM written to CSV files: APs within
1e-4 of JAX's, scores within 1e-3 relative), the pipeline fitted by the
port (mAP > 0.3, the JAX test's bound; its k-means++ draws are its own),
the JAX fit's parameters carried into the port (``fitted_from_arrays``,
scores within 1e-3 relative), and the command line on the CPU.

The JAX package's CLI draws 64-px synthetic images whatever
``--imageSize`` says; the port keeps that."""

import io
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JDataset
from keystone_tpu.loaders import images as jimages
from keystone_tpu.nodes.images import (
    FisherVector as JFisherVector,
    GrayScaler as JGray,
    PixelScaler as JPixel,
    SIFTExtractor as JSIFT,
)
from keystone_tpu.nodes.images.fisher_vector import GMMFisherVectorEstimator as JGMMFV
from keystone_tpu.nodes.learning import BatchPCATransformer as JBatchPCA
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JBLS
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBlockMapper
from keystone_tpu.nodes.learning.pca import LocalColumnPCAEstimator as JLocalPCA
from keystone_tpu.nodes.stats import ColumnSampler as JSampler
from keystone_tpu.nodes.stats import NormalizeRows as JNorm
from keystone_tpu.nodes.stats import SignedHellingerMapper as JSH
from keystone_tpu.nodes.util import Cacher as JCacher
from keystone_tpu.nodes.util import MatrixVectorizer as JMatVec
from keystone_tpu.nodes.util import MultiClassLabelIndicators as JLabels
from keystone_tpu.pipelines import voc_sift_fisher as jvoc
from keystone_tpu_torch.loaders import images as timages
from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
from keystone_tpu_torch.nodes.images.sift import SIFTExtractor
from keystone_tpu_torch.pipelines import voc_sift_fisher as tvoc
from keystone_tpu_torch.workflow import fusion
from keystone_tpu_torch.workflow.env import PipelineEnv

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
DESC_DIM, VOCAB, LAM = 16, 8, 10.0


@pytest.fixture(autouse=True)
def port_env():
    """The port's fit-once state, reset around each test."""
    env = PipelineEnv.get_or_create()
    env.reset()
    yield env
    env.reset()


# ---- the loader ------------------------------------------------------------

def _voc_tar(tmp_path, sizes):
    """A tar of JPEGs and PNGs under the VOC prefix, written by PIL, and its
    label CSV (one row per object)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    tar_path = tmp_path / "voc.tar"
    rows = ['"id","class","x","y","file"']
    with tarfile.open(tar_path, "w") as tf:
        for i, (h, w, mode, fmt) in enumerate(sizes):
            shape = (h, w, 3) if mode == "RGB" else (h, w)
            img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
            buf = io.BytesIO()
            img.save(buf, format=fmt)
            name = f"VOCdevkit/VOC2007/JPEGImages/{i:06d}.{fmt.lower()}"
            info = tarfile.TarInfo(name)
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
            for cl in {i % 20 + 1, (3 * i) % 20 + 1}:
                rows.append(f'{i},{cl},0,0,"{name}"')
        junk = b"not an image"
        info = tarfile.TarInfo("VOCdevkit/VOC2007/JPEGImages/broken.jpeg")
        info.size = len(junk)
        tf.addfile(info, io.BytesIO(junk))
    csv_path = tmp_path / "labels.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    return str(tar_path), str(csv_path)


@pytest.mark.parametrize("size", [None, (40, 48)])
def test_load_voc_matches_jax(tmp_path, size):
    sizes = [(50, 60, "RGB", "PNG"), (40, 40, "L", "PNG"), (30, 80, "RGB", "PNG"),
             (64, 48, "RGB", "JPEG")]
    tar, csv = _voc_tar(tmp_path, sizes)
    got = timages.load_voc(tar, csv, name_prefix="VOCdevkit/VOC2007/JPEGImages/", size=size)
    want = jimages.load_voc(tar, csv, name_prefix="VOCdevkit/VOC2007/JPEGImages/", size=size)
    assert got.names == want.names and len(got) == 3  # the 30-px image and the junk skipped
    assert [sorted(x) for x in got.labels] == [sorted(x) for x in want.labels]
    if size is None:
        for a, b in zip(got.data.collect(), want.data.collect()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        np.testing.assert_array_equal(got.data.to_array().numpy(), np.asarray(want.data.to_array()))
        assert tuple(got.data.to_array().shape) == (3, 40, 48, 3)
    np.testing.assert_array_equal(got.label_matrix(20), want.label_matrix(20))


def test_labels_map_and_imagenet_reader_match_jax(tmp_path):
    from PIL import Image

    (tmp_path / "map.txt").write_text("n01 0\nn02\t7\n")
    assert timages.read_labels_map(str(tmp_path / "map.txt")) == {"n01": 0, "n02": 7}
    tar_path = tmp_path / "in.tar"
    with tarfile.open(tar_path, "w") as tf:
        for i, d in enumerate(["n01", "n02", "n03"]):
            buf = io.BytesIO()
            Image.fromarray(np.full((40, 40, 3), 30 * i, np.uint8)).save(buf, format="PNG")
            info = tarfile.TarInfo(f"{d}/img{i}.png")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
    got = timages.load_imagenet(str(tar_path), str(tmp_path / "map.txt"), size=(36, 36))
    want = jimages.load_imagenet(str(tar_path), str(tmp_path / "map.txt"), size=(36, 36))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.data.to_array().numpy(), np.asarray(want.data.to_array()))


# ---- the pipeline ------------------------------------------------------------

@pytest.fixture(scope="module")
def voc_data():
    tr_i, tr_l = jvoc.synthetic_voc(48, seed=1)
    te_i, te_l = jvoc.synthetic_voc(16, seed=2)
    return tr_i, tr_l, te_i, te_l


@pytest.fixture(scope="module")
def jax_fit(voc_data, tmp_path_factory):
    """The JAX reference's fit, as ``run`` makes it with a local column PCA:
    its PCA matrix and GMM, written to CSV files as the load path reads
    them, its block model, and its test scores."""
    tr_i, tr_l, te_i, _ = voc_data
    n = len(tr_i)
    sift = JPixel().and_then(JGray()).and_then(JCacher()).and_then(JSIFT())
    descs = sift(tr_i).get()
    pca = JLocalPCA(DESC_DIM).fit(JSampler(20_000 // n, seed=0).apply_batch(descs))
    feats = JBatchPCA(pca.pca_mat).apply_batch(descs)
    fv = JGMMFV(VOCAB, max_iterations=20, min_cluster_size=1).fit(
        JSampler(20_000 // n, seed=1).apply_batch(feats))
    featurizer = (sift.and_then(JBatchPCA(pca.pca_mat)).and_then(JCacher())
                  .and_then(JFisherVector(fv.gmm)).and_then(JMatVec()).and_then(JNorm())
                  .and_then(JSH()).and_then(JNorm()).and_then(JCacher()))
    labels = JLabels(20).apply_batch(JDataset.from_items(list(tr_l)))
    predictor = featurizer.and_then(JBLS(4096, 1, LAM, num_features=2 * DESC_DIM * VOCAB),
                                    tr_i, labels)
    fitted = predictor.fit()
    mapper = next(op for op in fitted.graph.operators.values() if isinstance(op, JBlockMapper))
    d = tmp_path_factory.mktemp("voc_files")
    files = {"pca_file": d / "pca.csv", "gmm_mean_file": d / "m.csv",
             "gmm_var_file": d / "v.csv", "gmm_wts_file": d / "w.csv"}
    for key, arr in (("pca_file", np.asarray(pca.pca_mat).T), ("gmm_mean_file", fv.gmm.means),
                     ("gmm_var_file", fv.gmm.variances), ("gmm_wts_file", fv.gmm.weights)):
        np.savetxt(files[key], np.asarray(arr, np.float64), delimiter=",", fmt="%.9e")
    params = {"pca_mat": np.asarray(pca.pca_mat), "gmm_means": np.asarray(fv.gmm.means),
              "gmm_variances": np.asarray(fv.gmm.variances),
              "gmm_weights": np.asarray(fv.gmm.weights),
              "W": np.concatenate([np.asarray(x) for x in mapper.xs]), "b": np.asarray(mapper.b),
              "feature_means": np.concatenate([np.asarray(m) for m in mapper.feature_means])}
    scores = np.asarray(fitted.apply(JDataset.of(te_i)).to_array())
    return {k: str(v) for k, v in files.items()}, params, scores


def test_load_path_matches_jax(voc_data, jax_fit):
    tr_i, tr_l, te_i, te_l = voc_data
    files, _, _ = jax_fit
    kw = dict(vocab_size=VOCAB, desc_dim=DESC_DIM, lam=LAM, **files)
    want, _ = jvoc.run(tr_i, tr_l, te_i, te_l, jvoc.SIFTFisherConfig(**kw))
    details = {}
    got, _ = tvoc.run(tr_i, tr_l, te_i, te_l, tvoc.SIFTFisherConfig(**kw), CPU, details)
    assert got.shape == (20,)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert details["fv_width"] == 2 * DESC_DIM * VOCAB
    # no estimator before the block model: the pixels-to-FV chain is one group
    names = sorted(type(op).__name__ for op in details["fitted"].graph.operators.values())
    assert names == ["BlockLinearMapper", "FusedTransformerOperator"]
    np.testing.assert_allclose(details["scores"].numpy(), jax_fit[2], rtol=1e-3,
                               atol=1e-3 * np.abs(jax_fit[2]).max())


def test_fitted_by_the_port(voc_data):
    tr_i, tr_l, te_i, te_l = voc_data
    conf = tvoc.SIFTFisherConfig(num_pca_samples=20_000, num_gmm_samples=20_000,
                                 vocab_size=4, desc_dim=16, lam=10.0)
    details = {}
    aps, _ = tvoc.run(tr_i, tr_l, te_i, te_l, conf, CPU, details)
    assert aps.shape == (20,) and aps.mean() > 0.3, f"MAP {aps.mean()}"
    assert details["descriptors"] == SIFTExtractor().forward(torch.zeros(1, 64, 64, 1)).shape[2]
    assert 1 <= details["em_iterations"] <= 20
    assert details["pca_choice"] in ("LocalColumnPCAEstimator", "DistributedColumnPCAEstimator")
    assert set(details["phases"]) >= {"sift", "pca_fit", "gmm_samples", "seeding", "em",
                                      "featurize", "solve", "apply", "evaluate"}


def test_fitted_from_arrays_matches_the_jax_pipeline(voc_data, jax_fit):
    _, _, te_i, _ = voc_data
    _, params, want = jax_fit
    conf = tvoc.SIFTFisherConfig(desc_dim=DESC_DIM, vocab_size=VOCAB)
    fitted = tvoc.fitted_from_arrays(params, conf, CPU)
    got = fitted.apply(torch.from_numpy(te_i)).to_array().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    # one fused group from the pixels to the FV tail, then the block model
    assert [type(op).__name__ for op in fitted.graph.operators.values()] == [
        "FusedTransformerOperator", "BlockLinearMapper"]
    labels = tvoc.fitted_from_arrays(params, conf, CPU, classify=True).apply(
        torch.from_numpy(te_i)).to_array().numpy()
    np.testing.assert_array_equal(labels, got.argmax(1))


def test_fitted_chain_runs_in_chunks_cut_by_bytes(voc_data, jax_fit, monkeypatch):
    """The fused group from the pixels to the FV tail holds a row's SIFT
    descriptors, their projection and the FV posteriors: its chunks are cut
    to the byte budget, with the output of the whole batch (atol 1e-4 on
    unit-norm rows: a convolution over fewer images may round a SIFT entry
    across a quantization step)."""
    _, _, te_i, _ = voc_data
    _, params, _ = jax_fit
    fitted = tvoc.fitted_from_arrays(params, tvoc.SIFTFisherConfig(desc_dim=DESC_DIM,
                                                                   vocab_size=VOCAB), CPU)
    op = next(op for op in fitted.graph.operators.values()
              if isinstance(op, fusion.FusedTransformerOperator))
    X = torch.from_numpy(te_i)
    whole = op.forward(X)
    per_row = op.row_bytes([X])
    assert per_row > 4 * 128 * SIFTExtractor().forward(torch.zeros(1, 64, 64, 1)).shape[2]
    monkeypatch.setattr(fusion, "CHUNK_BYTES", 5 * per_row)
    assert op.chunk_rows([X]) == 5
    calls = []
    forward = fusion.FusedTransformerOperator.forward
    monkeypatch.setattr(fusion.FusedTransformerOperator, "forward",
                        lambda self, *xs: calls.append(xs[0].shape[0]) or forward(self, *xs))
    chunked = op.batch_transform([fusion.DatasetExpression.now(fusion.Dataset(X))]).to_array()
    assert calls == [5, 5, 5, 1]
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-4)


def test_fisher_vector_declares_its_posteriors():
    from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModel

    node = FisherVector(GaussianMixtureModel(torch.zeros(80, 256), torch.ones(80, 256),
                                             torch.full((256,), 1 / 256)))
    assert node.row_work_bytes(torch.zeros(1, 80, 23599)) >= 3 * 4 * 23599 * 256


def test_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "VOCSIFTFisher", "--device", "cpu",
         "--nTrain", "24", "--nTest", "12", "--descDim", "8", "--vocabSize", "4",
         "--numPcaSamples", "5000", "--numGmmSamples", "5000", "--lambda", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Mean Average Precision:" in proc.stdout


def test_cli_without_device_cpu_does_not_run_on_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "VOCSIFTFisher", "--nTrain", "8",
         "--nTest", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Mean Average Precision" not in proc.stdout
