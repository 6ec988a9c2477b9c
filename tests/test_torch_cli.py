"""The port's command line (``keystone_tpu_torch/__main__.py``) resolves
application names and demo flags as the JAX package's
(``keystone_tpu/__main__.py``): the same shorthand ``ALIASES``, any-case
names, and the same unambiguous-prefix rule over ``--serve-demo``,
``--sweep-demo`` and ``--trainer-demo``, held against the other long flags
(``--s`` and ``--tra`` are argparse's errors in both). The abbreviation
cases are those of ``tests/sweep/test_demo.py`` with ``--trainer-demo``
added; the demos' mains are replaced by recorders, so each case only
routes. Then ``mnist --device cpu --check`` and ``--trainer-demo --device
cpu`` run on the port."""

import argparse

import pytest

import keystone_tpu.__main__ as jcli
import keystone_tpu_torch.__main__ as cli
from keystone_tpu_torch.workflow.env import PipelineEnv

DEMOS = {"--serve-demo": ("serving", "demo"), "--sweep-demo": ("sweep", "demo"),
         "--trainer-demo": ("trainer", "demo")}


@pytest.fixture(autouse=True)
def port_env():
    PipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()


def test_aliases_are_the_jax_clis():
    assert cli.ALIASES == jcli.ALIASES
    assert set(cli.PIPELINES) == set(jcli.PIPELINES)


NAMES = (list(jcli.ALIASES) + [a.upper() for a in jcli.ALIASES] + list(jcli.PIPELINES)
         + [n.lower() for n in jcli.PIPELINES] + [n.upper() for n in jcli.PIPELINES]
         + ["Mnist", "cIfAr", "timitpipeline"])


@pytest.mark.parametrize("name", NAMES)
def test_names_resolve_as_in_jax(name):
    p = argparse.ArgumentParser()
    assert cli.resolve_pipeline(p, name) == jcli._resolve_pipeline(p, name)


@pytest.mark.parametrize("name", ["mnst", "cifar10", "", "Random"])
def test_unknown_names_are_argparse_errors_in_both(name):
    for resolve in (cli.resolve_pipeline, jcli._resolve_pipeline):
        with pytest.raises(SystemExit):
            resolve(argparse.ArgumentParser(), name)


def _routes(main, package, monkeypatch, argv):
    """Which demo ``main(argv)`` runs, with every demo's main recorded."""
    import importlib

    ran = []
    for flag, (sub, mod) in DEMOS.items():
        module = importlib.import_module(f"{package}.{sub}.{mod}")
        monkeypatch.setattr(module, "main",
                            lambda argv=None, flag=flag: ran.append((flag, list(argv))) or 0)
    assert main(argv) == 0
    return ran


@pytest.mark.parametrize("arg, flag", [
    ("--serve-demo", "--serve-demo"), ("--serve", "--serve-demo"), ("--se", "--serve-demo"),
    ("--sweep-demo", "--sweep-demo"), ("--sweep-d", "--sweep-demo"), ("--sw", "--sweep-demo"),
    ("--trainer-demo", "--trainer-demo"), ("--trainer", "--trainer-demo"),
    ("--trai", "--trainer-demo"),
])
def test_demo_flag_prefixes_route_as_in_jax(arg, flag, monkeypatch):
    got = _routes(cli.main, "keystone_tpu_torch", monkeypatch, [arg, "--nTrain", "64"])
    want = _routes(jcli.main, "keystone_tpu", monkeypatch, [arg, "--nTrain", "64"])
    assert cli.demo_flag(arg) == flag
    assert [f for f, _ in got] == [f for f, _ in want] == [flag]
    assert got[0][1] == want[0][1] == ["--nTrain", "64"]


@pytest.mark.parametrize("arg", ["--s", "--tra", "--tr", "--t", "--p"])
def test_ambiguous_prefixes_stay_argparse_errors(arg, monkeypatch, capsys):
    """The shared prefix ``--s`` matches neither demo, and ``--tra`` is
    ambiguous between ``--trace`` and ``--trainer-demo``: argparse's error
    (exit 2) in both packages, no demo run."""
    assert cli.demo_flag(arg) is None
    for main, package in ((cli.main, "keystone_tpu_torch"), (jcli.main, "keystone_tpu")):
        with pytest.raises(SystemExit) as exit_:
            _routes(main, package, monkeypatch, [arg])
        assert exit_.value.code == 2
        assert "ambiguous option" in capsys.readouterr().err


def test_a_missing_application_is_an_argparse_error(capsys):
    with pytest.raises(SystemExit) as exit_:
        cli.main(["--device", "cpu"])
    assert exit_.value.code == 2
    assert "pipeline" in capsys.readouterr().err


def test_mnist_shorthand_checks_on_the_cpu(capsys):
    assert cli.main(["mnist", "--device", "cpu", "--check"]) == 0
    assert "CHECK OK:" in capsys.readouterr().out


def test_any_case_name_runs_where_the_name_is_not_first(capsys):
    assert cli.main(["--check", "MNISTRANDOMFFT", "--device", "cpu", "--numFFTs", "2"]) == 0
    assert "CHECK OK:" in capsys.readouterr().out


def test_trainer_demo_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    assert cli.main(["--trainer-demo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "TRAINER PASS" in out
    assert "failures=0" in out and "skew=False" in out


def test_trainer_demo_refuses_to_run_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--trainer-demo"])
