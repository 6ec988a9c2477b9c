"""The port's ``--sweep-demo`` (``keystone_tpu_torch/sweep/demo.py``): the
cases of the JAX package's ``tests/sweep/test_demo.py``, with the JAX CLI
run on the same arguments and the same work counts printed by both.
"""

import re

import pytest

from keystone_tpu.__main__ import main as jmain
from keystone_tpu_torch.__main__ import main
from keystone_tpu_torch.workflow.env import PipelineEnv

ARGS = ["--grid", "1e-2,1e-1", "--nTrain", "512", "--nAppend", "64",
        "--dim", "32", "--classes", "4", "--requests", "8"]


@pytest.fixture(autouse=True)
def port_env():
    PipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()


def _counts(out: str) -> dict:
    """The work counts both demos print (not the model's numbers)."""
    keys = ("members", "prefix_full_executions", "gram_reuse_solves", "groups", "appended",
            "total_rows", "ok", "buckets_warmed", "served", "completed", "failed")
    return {k: re.search(rf"\b{k}=(\S+)", out).group(1) for k in keys}


def test_sweep_demo_smoke(capsys):
    rc = main(["--sweep-demo", "--device", "cpu", *ARGS])
    out = capsys.readouterr().out
    assert rc == 0
    assert "SWEEP PASS" in out
    assert "prefix_full_executions=1" in out
    assert "gram_reuse_solves=2" in out
    assert "failed=0" in out
    assert jmain(["--sweep-demo", "--backend", "cpu", *ARGS]) == 0
    assert _counts(out) == _counts(capsys.readouterr().out)


def test_demo_flag_prefixes_stay_unambiguous():
    """The shared prefix ``--s`` names neither demo: both CLIs refuse it."""
    with pytest.raises(SystemExit):
        main(["--s", "--device", "cpu"])
    with pytest.raises(SystemExit):
        jmain(["--s", "--backend", "cpu"])
