"""Whole runs of every cell on the CPU at tiny sizes: the plain reference
agrees with the port, and a run whose timed path is broken underneath
comes out not correct: a step that returns its state unchanged, a mean
taken over half of the rows, an answer altered where it is produced, a
featurizer's rows altered. (The
card itself is not looked for: ``run_cell`` takes the device.)"""

import pytest
import torch

from benchmark import harness

TINY = {
    "cifar_kernel.run": dict(num_train=400, num_test=120, block_size=150, whitener_size=5000),
    "cifar_kernel.apply": dict(num_train=400, num_test=120, block_size=150,
                               whitener_size=5000),
    "timit.run": dict(num_train=500, num_test=120, num_cosines=2, cosine_features=128,
                      num_epochs=2, block_size=128),
}
TRAFFIC = {"cifar_kernel.apply": dict(rows=50, distinct=2)}


def run(workload, seed=2**31 + 11, **kw):
    return harness.run_cell(workload, seed, 0.0, False, device="cpu",
                            overrides=TINY[workload],
                            traffic_overrides=TRAFFIC.get(workload), warmup=False,
                            log=lambda s: None, **kw)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_agrees_with_the_port(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert check["value"] < check["limit"]


def test_control_switches_only_the_products_precision():
    # TF32 has no effect on the CPU: the control run is the sound run here
    result = run("cifar_kernel.run", control="tf32")
    assert result["correct"]
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(harness.BenchmarkError):
        run("cifar_kernel.run", control="bf16")


@pytest.mark.parametrize("workload", ["cifar_kernel.run", "cifar_kernel.apply"])
def test_k1_control_takes_k1s_place_and_gives_it_back(workload):
    from keystone_tpu_torch.nodes.learning import kernel

    k1 = kernel._gaussian_block
    result = run(workload, control="k1_tf32")
    # one TF32 pass is the plain float32 block on the CPU
    assert result["correct"], result["checks"]
    assert kernel._gaussian_block is k1 and not torch.backends.cuda.matmul.allow_tf32


def test_k1_control_is_the_plain_block_in_float32_on_the_cpu():
    from benchmark.controls import k1_tf32
    from benchmark.reference.cifar_random_patch_kernel import kernel

    gen = torch.Generator().manual_seed(5)
    X, Xb = torch.randn(40, 16, generator=gen), torch.randn(30, 16, generator=gen)
    want = kernel(X.double(), Xb.double(), 0.05)
    assert (k1_tf32.k1_one_pass(X, Xb, 0.05).double() - want).abs().max() < 1e-5


def test_taps_are_closed_after_a_run():
    from keystone_tpu_torch.nodes.learning.kernel import KernelBlockLinearMapper
    from keystone_tpu_torch.nodes.learning.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow import pipeline

    def taps():
        return (KernelBlockLinearMapper.forward, BlockLeastSquaresEstimator.fit,
                pipeline.Pipeline.fit, pipeline._static_check)

    before = taps()
    run("timit.run")
    run("cifar_kernel.run")
    assert taps() == before


# ---- faults planted under the timed path -----------------------------------

def krr_state_unchanged(monkeypatch):
    from keystone_tpu_torch.nodes.learning import kernel

    monkeypatch.setattr(kernel, "_block_update", lambda *a, **k: None)


def bcd_state_unchanged(monkeypatch):
    from keystone_tpu_torch.linalg import bcd

    def step(Aj, mj, Wj_old, pred, y, reg):
        return Wj_old, pred

    step.steps = 0
    monkeypatch.setattr(bcd, "_block_update_impl", step)


def scaler_over_half(monkeypatch):
    from keystone_tpu_torch.nodes.stats import core

    fit = core.StandardScaler.fit

    def half(self, data):
        from keystone_tpu_torch.data.dataset import Dataset

        X = Dataset.of(data).to_array()
        return fit(self, Dataset(X[: X.shape[0] // 2]))

    monkeypatch.setattr(core.StandardScaler, "fit", half)


def means_over_half(monkeypatch):
    from keystone_tpu_torch.linalg import bcd
    from keystone_tpu_torch.nodes.learning import linear

    def block_means(blocks, y):
        h = y.shape[0] // 2
        return [b[:h].mean(dim=0) for b in blocks], y.mean(dim=0)

    monkeypatch.setattr(bcd, "_block_means", block_means)
    monkeypatch.setattr(linear, "_block_means", block_means)


def kernel_scores_altered(monkeypatch):
    from keystone_tpu_torch.nodes.learning import kernel

    forward = kernel.KernelBlockLinearMapper.forward

    def altered(self, X):
        out = forward(self, X)
        out[0, 0] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(kernel.KernelBlockLinearMapper, "forward", altered)


def linear_scores_altered(monkeypatch):
    from keystone_tpu_torch.nodes.learning import linear

    forward = linear.BlockLinearMapper.forward

    def altered(self, X):
        out = forward(self, X)
        out[0, 0] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(linear.BlockLinearMapper, "forward", altered)


def cosine_rows_altered(monkeypatch):
    from keystone_tpu_torch.nodes.stats import core

    forward = core.CosineRandomFeatures.forward

    def altered(self, X):
        out = forward(self, X).clone()
        out[::7] *= 1.01
        return out

    monkeypatch.setattr(core.CosineRandomFeatures, "forward", altered)


def half_the_batch_scored(monkeypatch):
    from keystone_tpu_torch.nodes.learning import kernel

    forward = kernel.KernelBlockLinearMapper.forward

    def half(self, X):
        out = forward(self, X[: X.shape[0] // 2])
        return torch.cat([out, out])[: X.shape[0]]

    monkeypatch.setattr(kernel.KernelBlockLinearMapper, "forward", half)


FAULTS = [
    ("cifar_kernel.run", krr_state_unchanged),
    ("cifar_kernel.run", scaler_over_half),
    ("cifar_kernel.run", kernel_scores_altered),
    ("cifar_kernel.apply", krr_state_unchanged),
    ("cifar_kernel.apply", kernel_scores_altered),
    ("cifar_kernel.apply", half_the_batch_scored),
    ("timit.run", bcd_state_unchanged),
    ("timit.run", means_over_half),
    ("timit.run", linear_scores_altered),
    ("timit.run", cosine_rows_altered),
]


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(workload)
    assert not result["correct"], result["checks"]
