"""The port's pipeline fingerprint (``keystone_tpu_torch/compile/
fingerprint.py``): every case of the JAX package's
``tests/compile/test_fingerprint.py`` on a port toy chain built like its
``build_toy``, the content hashing of shared value kinds and the entry key
held equal to the JAX package's, and the two chains the AOT cache serves
(RandomPatchCifarKernel's KRR chain and the serving demo's MnistRandomFFT
chain) stable across ``dumps``/``loads`` and across two processes.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import keystone_tpu.compile.fingerprint as jfp
import keystone_tpu_torch.compile.fingerprint as tfp
from keystone_tpu_torch.compile import FingerprintError, entry_key, pipeline_fingerprint
from keystone_tpu_torch.utils import serialization
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import FunctionNode, Transformer

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_env():
    PipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()


def _double(X):
    return X * 2.0


class _Scale(Transformer):
    """A fitted parameter held as a tensor."""

    def __init__(self, w):
        self.w = torch.as_tensor(w)

    def forward(self, X):
        return X * self.w


def build_toy(scale: float = 3.0):
    """A transformer-only chain built the same way in any process."""
    w = np.arange(8, dtype=np.float32) * scale + 1.0
    return (FunctionNode(batch_fn=_double, label="double") >> _Scale(w)).fit()


def toy_digest(scale: float = 3.0) -> str:
    return pipeline_fingerprint(build_toy(scale))


def test_rebuild_gives_identical_digest():
    assert toy_digest() == toy_digest()


def test_digest_moves_with_parameters():
    assert toy_digest(3.0) != toy_digest(4.0)


def test_digest_stable_after_use():
    """Running the chain fills memo state (a fused group's graphs and row
    bytes); a warm pipeline fingerprints as a fresh one."""
    fitted = build_toy()
    before = pipeline_fingerprint(fitted)
    fitted.apply(torch.ones(4, 8))
    fitted.compile(cache=None)(torch.ones(4, 8))
    assert pipeline_fingerprint(fitted) == before


def test_digest_survives_pickle_round_trip():
    fitted = build_toy()
    clone = serialization.loads(serialization.dumps(fitted))
    assert pipeline_fingerprint(clone) == pipeline_fingerprint(fitted)


def _in_subprocess(expr: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_fingerprint import *; print({expr})"],
        cwd=_REPO_ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_digest_stable_across_processes():
    """What the cache stands on: another process building the same fitted
    pipeline derives the same key."""
    assert _in_subprocess("toy_digest()") == toy_digest()


def _inner3(X):
    return (lambda: 3.0)() * X


def _inner4(X):
    return (lambda: 4.0)() * X


def _kw2(X, *, s=2.0):
    return X * s


def _kw3(X, *, s=3.0):
    return X * s


def _fp(fn):
    return pipeline_fingerprint(FunctionNode(batch_fn=fn, label="f").to_pipeline().fit())


def test_digest_sees_nested_code_and_kwdefaults():
    assert _fp(_inner3) != _fp(_inner4)
    assert _fp(_kw2) != _fp(_kw3)


def _with_global(scale: float):
    ns = {"SCALE": scale}
    exec("def f(X):\n    return X * SCALE", ns)
    return ns["f"]


def test_digest_sees_referenced_module_globals():
    assert _fp(_with_global(2.0)) != _fp(_with_global(3.0))
    assert _fp(_with_global(2.0)) == _fp(_with_global(2.0))


def test_object_dtype_arrays_digest_by_content_not_pointers():
    def fp(meta):
        fitted = build_toy()
        next(iter(fitted.graph.operators.values())).meta = np.array(meta, dtype=object)
        return pipeline_fingerprint(fitted)

    assert fp(["a", 1.5]) == fp(["a", 1.5])
    assert fp(["a", 1.5]) != fp(["b", 1.5])


def test_uncanonicalizable_state_raises():
    class Opaque(Transformer):
        def __init__(self):
            self.handle = object()  # no content-stable form

        def forward(self, X):
            return X

    fitted = (FunctionNode(batch_fn=_double, label="double") >> Opaque()).fit()
    with pytest.raises(FingerprintError, match="handle"):
        pipeline_fingerprint(fitted)


def test_a_generator_has_no_canonical_form():
    fitted = build_toy()
    next(iter(fitted.graph.operators.values())).gen = torch.Generator().manual_seed(0)
    with pytest.raises(FingerprintError, match="gen"):
        pipeline_fingerprint(fitted)


def test_entry_key_separates_signature_and_environment():
    env = {"torch": "1", "backend": "cpu"}
    base = entry_key("a" * 64, (8, 4), "float32", env)
    assert entry_key("a" * 64, (16, 4), "float32", env) != base
    assert entry_key("a" * 64, (8, 4), "float64", env) != base
    assert entry_key("a" * 64, (8, 4), "float32", {**env, "torch": "2"}) != base
    assert entry_key("b" * 64, (8, 4), "float32", env) != base
    assert entry_key("a" * 64, (8, 4), "float32", dict(env)) == base


# ---------------------------------------------------------------------------
# held against the JAX package's
# ---------------------------------------------------------------------------


def test_entry_keys_equal_the_jax_packages():
    env = {"torch": "2.13", "backend": "cuda", "device_name": "H100"}
    for shape, dtype in (((8, 4), "float32"), ((1, 32, 32, 3), "float64")):
        assert (tfp.entry_key("c" * 64, shape, dtype, env)
                == jfp.entry_key("c" * 64, shape, dtype, env))
    sigs = (((8, 4), "float32"), ((8, 2), "float32"))
    assert tfp.segment_entry_key("d" * 64, sigs, env) == jfp.segment_entry_key("d" * 64, sigs, env)


@pytest.mark.parametrize("value", [
    None, True, 3, 2.5, 1j, "s", b"b", np.float32(1.5),
    np.arange(6, dtype=np.float32).reshape(2, 3), np.array(["a", 1.5], dtype=object),
    [1, (2.0, "x")], {"b": 1, "a": [2]}, {3, 1, 2}, frozenset({"x"}), np.dtype("int16"),
    _kw2, _inner3, np.add, len,
])
def test_shared_value_kinds_hash_as_in_the_jax_package(value):
    """Values both packages hold (scalars, numpy arrays, containers, plain
    functions, ufuncs, builtins) feed the same bytes into the digest."""
    digests = []
    for mod in (jfp, tfp):
        h = hashlib.sha256()
        mod._feed(h, value, "v")
        digests.append(h.hexdigest())
    assert digests[0] == digests[1]


def test_a_tensor_hashes_as_its_host_array():
    """A tensor digests by shape, dtype and bytes wherever it lives: as the
    JAX package digests an array's shape, dtype and bytes (only the dtype's
    spelling differs), and bfloat16 by its bytes."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    h = hashlib.sha256()
    tfp._feed(h, torch.from_numpy(a), "t")
    want = hashlib.sha256()
    for tag, payload in ((b"A", str((3, 4)).encode()), (b"a", b"torch.float32"),
                         (b"d", hashlib.sha256(a.tobytes()).digest())):
        tfp._feed_bytes(want, tag, payload)
    assert h.hexdigest() == want.hexdigest()
    b16 = torch.arange(6, dtype=torch.bfloat16)
    h1, h2 = hashlib.sha256(), hashlib.sha256()
    tfp._feed(h1, b16, "t")
    tfp._feed(h2, b16.clone(), "t")
    assert h1.hexdigest() == h2.hexdigest()
    h3 = hashlib.sha256()
    tfp._feed(h3, b16 + 1, "t")
    assert h3.hexdigest() != h1.hexdigest()


def test_environment_key_names_the_toolchain_and_device():
    env = tfp.environment_key(CPU)
    assert env == {"format": "1", "torch": torch.__version__, "cuda": str(torch.version.cuda),
                   "backend": "cpu", "device_name": "cpu", "capability": "none"}


# ---------------------------------------------------------------------------
# the chains the AOT cache serves
# ---------------------------------------------------------------------------


def cifar_krr_fitted(seed: int = 0, classify: bool = True):
    """RandomPatchCifarKernel's fitted KRR chain at a small width, its
    parameters drawn with numpy from ``seed``; without ``classify`` it ends
    at the scores."""
    from keystone_tpu_torch.pipelines import cifar_extras as tce

    rng = np.random.default_rng(seed)
    conf = tce.KernelCifarConfig(num_filters=8, lam=1.0, gamma=1e-3, block_size=16,
                                 num_epochs=1, cache_kernel=False, pool_size=8, pool_stride=7)
    dp = conf.patch_size ** 2 * 3
    d = 4 * 4 * 2 * 8  # 4 × 4 pools, 2 rectified signs, 8 filters
    params = dict(filters=rng.standard_normal((8, dp)), whitener=0.1 * rng.standard_normal((dp, dp)),
                  means=rng.standard_normal(dp), scaler_mean=rng.standard_normal(d),
                  scaler_std=1.0 + rng.random(d), train_X=rng.standard_normal((40, d)),
                  W=rng.standard_normal((40, 10)), gamma=1e-3, block_size=16)
    return tce.fitted_from_arrays(params, conf, CPU, classify=classify)


def cifar_digest() -> str:
    return pipeline_fingerprint(cifar_krr_fitted())


def mnist_demo_digest() -> str:
    from keystone_tpu_torch.serving.demo import build_demo_fitted

    fitted, _ = build_demo_fitted(n_train=256, n_test=8, device=CPU)
    return pipeline_fingerprint(fitted)


@pytest.mark.parametrize("build", ["cifar", "mnist"])
def test_the_served_chains_fingerprint_stably(build):
    """Both chains fingerprint (no state without a canonical form), equal
    after ``dumps``/``loads``, after an apply and in another process."""
    from keystone_tpu_torch.serving.demo import build_demo_fitted

    if build == "cifar":
        fitted, x, expr = cifar_krr_fitted(), torch.rand(4, 32, 32, 3), "cifar_digest()"
    else:
        fitted, data = build_demo_fitted(n_train=256, n_test=8, device=CPU)
        x, expr = torch.as_tensor(data[:4]), "mnist_demo_digest()"
    digest = pipeline_fingerprint(fitted)
    clone = serialization.loads(serialization.dumps(fitted))
    assert pipeline_fingerprint(clone) == digest
    fitted.apply(x)
    assert pipeline_fingerprint(fitted) == digest
    assert _in_subprocess(expr) == digest
    assert pipeline_fingerprint(cifar_krr_fitted(seed=1)) != cifar_digest()
