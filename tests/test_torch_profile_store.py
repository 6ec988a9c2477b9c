"""The port's profile store (``keystone_tpu_torch/cost/store.py``): every
case of the JAX package's ``tests/cost/test_profile_store.py`` on the
port's store (round trip, misses, corruption tolerance, environment
isolation, two processes updating one record), and a record the JAX
package wrote into the same directory: a miss in the port, left on disk,
read without importing anything of the JAX package.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from keystone_tpu_torch.cost.store import ProfileStore, profile_environment

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def store(tmp_path):
    return ProfileStore(str(tmp_path), device="cpu")


def test_round_trip(store):
    rec = {"spu": 1.25, "seconds_per_item": 3e-6, "solver_observations": 2}
    store.store("op/LinearMapEstimator", rec)
    assert store.load("op/LinearMapEstimator") == rec
    assert store.keys() == ["op/LinearMapEstimator"]


def test_miss_returns_none(store):
    assert store.load("op/Nothing") is None


def test_update_read_modify_write(store):
    store.update("op/X", lambda r: {"n": 1} if r is None else {"n": r["n"] + 1})
    store.update("op/X", lambda r: {"n": 1} if r is None else {"n": r["n"] + 1})
    assert store.load("op/X") == {"n": 2}


def test_overwrite_replaces(store):
    store.store("op/X", {"v": 1})
    store.store("op/X", {"v": 2})
    assert store.load("op/X") == {"v": 2}


def test_distinct_keys_distinct_files(store):
    store.store("op/A", {"v": 1})
    store.store("plan/A", {"v": 2})
    assert store.load("op/A") == {"v": 1}
    assert store.load("plan/A") == {"v": 2}


def test_invalid_key_rejected(store):
    with pytest.raises(ValueError):
        store.path("")


def _path_of(store, key):
    store.store(key, {"v": 1})
    return store.path(key)


def test_truncated_file_degrades_to_miss(store):
    path = _path_of(store, "op/T")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert store.load("op/T") is None
    assert not os.path.exists(path)  # a corrupt record is discarded


def test_garbage_file_degrades_to_miss(store):
    path = _path_of(store, "op/G")
    with open(path, "wb") as f:
        f.write(b"\x00\xffnot json at all")
    assert store.load("op/G") is None


def test_checksum_mismatch_degrades_to_miss(store):
    path = _path_of(store, "op/C")
    with open(path) as f:
        doc = json.load(f)
    doc["record"]["v"] = 999  # the payload changed under the old checksum
    with open(path, "w") as f:
        json.dump(doc, f)
    assert store.load("op/C") is None


def test_renamed_foreign_file_degrades_to_miss(store):
    src = _path_of(store, "op/Src")
    dst = store.path("op/Dst")
    os.replace(src, dst)  # its embedded key says op/Src
    assert store.load("op/Dst") is None


def test_corrupt_then_rewrite_recovers(store):
    path = _path_of(store, "op/R")
    with open(path, "wb") as f:
        f.write(b"junk")
    assert store.load("op/R") is None
    store.store("op/R", {"v": 7})
    assert store.load("op/R") == {"v": 7}


def test_env_mismatch_isolated(tmp_path):
    card = ProfileStore(str(tmp_path), env={"backend": "cuda", "device_kind": "H100"})
    cpu = ProfileStore(str(tmp_path), env={"backend": "cpu", "device_kind": "cpu"})
    card.store("op/X", {"spu": 9.0})
    assert cpu.load("op/X") is None
    cpu.store("op/X", {"spu": 2.0})
    assert card.load("op/X") == {"spu": 9.0}
    assert cpu.load("op/X") == {"spu": 2.0}


def test_env_payload_validated_on_handcopied_file(tmp_path):
    a = ProfileStore(str(tmp_path), env={"backend": "cuda", "device_kind": "a"})
    b = ProfileStore(str(tmp_path), env={"backend": "cpu", "device_kind": "b"})
    a.store("op/X", {"spu": 9.0})
    os.replace(a.path("op/X"), b.path("op/X"))
    assert b.load("op/X") is None  # the payload's environment differs
    assert os.path.exists(b.path("op/X"))  # stale, not corrupt: kept


def test_profile_environment_shape():
    """The port's own key: the backend, the device's name, and the torch
    and CUDA versions (the JAX package keys backend and device kind). A
    CPU environment and a card's differ in the backend."""
    env = profile_environment("cpu")
    assert set(env) == {"backend", "device_kind", "torch", "cuda"}
    assert env["backend"] == "cpu" and env["device_kind"] == "cpu"
    import torch

    assert env["torch"] == torch.__version__


_WORKER = """
import sys
from keystone_tpu_torch.cost.store import ProfileStore

store = ProfileStore(sys.argv[1], env={"backend": "cpu", "device_kind": "t"})
me = sys.argv[2]
for i in range(40):
    store.update(
        "op/Shared",
        lambda r: {"count": (0 if r is None else r.get("count", 0)) + 1, "last": me},
    )
    store.store(f"op/Only{me}", {"i": i})
print("done", me)
"""


def test_two_process_concurrent_update(tmp_path):
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path), name],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT)
        for name in ("A", "B")
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    store = ProfileStore(str(tmp_path), env={"backend": "cpu", "device_kind": "t"})
    shared = store.load("op/Shared")
    assert shared is not None
    assert shared["last"] in ("A", "B")
    assert 1 <= shared["count"] <= 80
    assert store.load("op/OnlyA") == {"i": 39}
    assert store.load("op/OnlyB") == {"i": 39}
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


_READ_JAX_RECORD = """
import os, sys
from keystone_tpu_torch.cost.store import ProfileStore

store = ProfileStore(sys.argv[1], device="cpu")
assert store.load("op/LinearMapEstimator") is None
assert store.keys() == []
# the JAX record, copied by hand onto the port's file name: its payload's
# environment is another's, so it is a miss too, and it is kept
os.replace(sys.argv[2], store.path("op/LinearMapEstimator"))
assert store.load("op/LinearMapEstimator") is None
assert os.path.exists(store.path("op/LinearMapEstimator"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "keystone_tpu")]
assert not bad, bad
print("ok")
"""


def test_a_jax_record_is_a_miss_left_on_disk_and_imports_nothing(tmp_path):
    from keystone_tpu.cost.store import ProfileStore as JProfileStore

    jstore = JProfileStore(str(tmp_path))
    path = jstore.store("op/LinearMapEstimator", {"spu": 3.0})
    copy = tmp_path / "copy.json"
    copy.write_bytes(Path(path).read_bytes())
    proc = subprocess.run([sys.executable, "-c", _READ_JAX_RECORD, str(tmp_path), str(copy)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(path)
    assert jstore.load("op/LinearMapEstimator") == {"spu": 3.0}
