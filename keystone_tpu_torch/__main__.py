"""Command line: ``python -m keystone_tpu_torch <App> [--device cpu] ...``.

The port runs the JAX package's twelve applications, with the flags of its
CLI: the CIFAR family (RandomPatchCifar, LinearPixels, RandomCifar,
RandomPatchCifarAugmented, RandomPatchCifarKernel), MnistRandomFFT,
TimitPipeline, VOCSIFTFisher, ImageNetSiftLcsFV, NewsgroupsPipeline,
AmazonReviewsPipeline and StupidBackoffPipeline. Each runs on CUDA unless
``--device cpu`` is given, but StupidBackoffPipeline, whose language model
is host numpy.

Four flags of the JAX CLI apply to every application: ``--trace PATH``
records a per-node trace and writes it as Chrome-trace JSON to ``PATH``
when the application ends, failed or not (also ``KEYSTONE_TRACE``);
``--profiles DIR`` keeps the operator-profile store in ``DIR``, from which
the second fit of a pipeline plans its solver choice and caching with zero
sampling executions (also ``KEYSTONE_PROFILE_DIR``); ``--aot-cache DIR``
keeps the AOT executable cache in ``DIR``, so a fitted chain's compiled
programs load from it instead of being traced again (also
``KEYSTONE_AOT_CACHE``); and ``--check`` builds
the application, runs the static checker at its first fit's entry, prints
the report and ``CHECK OK: ...`` and exits 0 without fitting (a proven
defect raises ``PipelineCheckError``). On the command line ``--log LEVEL``
(``--logLevel``) and ``--profile`` set logging and phase profiling, as in
the JAX CLI.

``python -m keystone_tpu_torch --serve-demo [--device cpu] [flags]`` fits
the small MnistRandomFFT pipeline and serves synthetic traffic through
``ServingEngine`` (``serving/demo.py``); ``--sweep-demo`` fits a λ grid
as one merged DAG, absorbs appended rows and hot-swaps the result into a
live engine (``sweep/demo.py``); ``--trainer-demo`` runs the continual-
learning loop against a live fleet (``trainer/demo.py``).

Names resolve as in the JAX CLI: the shorthands of :data:`ALIASES`
(``mnist``, ``cifar``, ...) and any-case application names; a demo flag
may be abbreviated to any prefix that no other long flag shares
(``--serve``, ``--sweep-d``, ``--trai``), and an ambiguous one (``--s``,
``--tra``) is argparse's error.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from .pipelines import (
    amazon_reviews,
    cifar_extras,
    imagenet_sift_lcs_fv,
    mnist_random_fft,
    newsgroups,
    random_patch_cifar,
    stupid_backoff_pipeline,
    timit,
    voc_sift_fisher,
)

#: application name → (runner returning a result dict, CLI main)
PIPELINES = {
    "RandomPatchCifar": (random_patch_cifar.run_app, random_patch_cifar.main),
    "LinearPixels": (cifar_extras.run_app, cifar_extras.main),
    "RandomCifar": (cifar_extras.run_app, cifar_extras.main),
    "RandomPatchCifarAugmented": (cifar_extras.run_app, cifar_extras.main),
    "RandomPatchCifarKernel": (cifar_extras.run_app, cifar_extras.main),
    "MnistRandomFFT": (mnist_random_fft.run_app, mnist_random_fft.main),
    "TimitPipeline": (timit.run_app, timit.main),
    "VOCSIFTFisher": (voc_sift_fisher.run_app, voc_sift_fisher.main),
    "ImageNetSiftLcsFV": (imagenet_sift_lcs_fv.run_app, imagenet_sift_lcs_fv.main),
    "NewsgroupsPipeline": (newsgroups.run_app, newsgroups.main),
    "AmazonReviewsPipeline": (amazon_reviews.run_app, amazon_reviews.main),
    "StupidBackoffPipeline": (stupid_backoff_pipeline.run_app, stupid_backoff_pipeline.main),
}


#: shorthand → application name (the full names stay the registry's keys;
#: these are command-line conveniences only), the JAX CLI's
ALIASES = {
    "mnist": "MnistRandomFFT",
    "cifar": "RandomPatchCifar",
    "voc": "VOCSIFTFisher",
    "imagenet": "ImageNetSiftLcsFV",
    "timit": "TimitPipeline",
    "newsgroups": "NewsgroupsPipeline",
    "amazon": "AmazonReviewsPipeline",
}

#: the demo modes, each replacing the application name
DEMO_FLAGS = ("--serve-demo", "--sweep-demo", "--trainer-demo")
#: every other long flag the port's command line registers: a demo flag's
#: abbreviation must not be a prefix of one of these either
OTHER_FLAGS = ("--trace", "--profiles", "--aot-cache", "--check", "--log", "--logLevel",
               "--profile", "--device")


def demo_flag(arg: str) -> Optional[str]:
    """The demo flag ``arg`` names: itself or a prefix that no other demo
    flag and no other long flag shares, as argparse would resolve it; None
    otherwise (an ambiguous prefix is left to argparse's error)."""
    if len(arg) <= 2 or not arg.startswith("--"):
        return None
    demos = [f for f in DEMO_FLAGS if f.startswith(arg)]
    if len(demos) != 1 or any(f.startswith(arg) for f in OTHER_FLAGS):
        return None
    return demos[0]


def _with_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``p`` with the flags every application and demo takes."""
    p.add_argument("--trace", default=None, metavar="PATH")
    p.add_argument("--profiles", default=None, metavar="DIR")
    p.add_argument("--aot-cache", default=None, metavar="DIR", dest="aot_cache")
    p.add_argument("--check", action="store_true", dest="check_only")
    p.add_argument("--log", "--logLevel", dest="log_level", default=None,
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--profile", action="store_true")
    return p


def _parser(demo: bool) -> argparse.ArgumentParser:
    """The command line's own flags, for ``-h`` and for argparse's errors
    (an ambiguous or missing option); ``_observed`` applies them."""
    p = argparse.ArgumentParser(prog="python -m keystone_tpu_torch",
                                description="Run an application of the port.")
    if not demo:
        p.add_argument("pipeline", metavar="pipeline",
                       help="one of: " + ", ".join(sorted(PIPELINES))
                       + " (case-insensitive; shorthands: " + ", ".join(sorted(ALIASES)) + ")")
    for flag, what in zip(DEMO_FLAGS, ("serve synthetic traffic (serving/demo.py)",
                                       "a λ grid, absorb and swap (sweep/demo.py)",
                                       "the continual-learning loop (trainer/demo.py)")):
        p.add_argument(flag, action="store_true", help=f"demo mode: {what}")
    p.add_argument("--device", default=None)
    return _with_flags(p)


def resolve_pipeline(parser: argparse.ArgumentParser, name: str) -> str:
    """``name`` as an application name: itself, a shorthand of
    :data:`ALIASES`, or a name in any case; argparse's error otherwise."""
    if name in PIPELINES:
        return name
    lowered = {k.lower(): k for k in PIPELINES}
    full = ALIASES.get(name.lower()) or lowered.get(name.lower())
    if full is None:
        parser.error(f"argument pipeline: invalid choice: {name!r} "
                     f"(choose from {', '.join(sorted(PIPELINES))})")
    return full


def _app(argv: list):
    """The application ``argv`` names, with the name resolved and moved to
    the front of ``argv`` (in place), where the application's parser reads
    it."""
    p = _parser(demo=False)
    args, _ = p.parse_known_args(argv)
    full = resolve_pipeline(p, args.pipeline)
    argv.remove(args.pipeline)
    argv.insert(0, full)
    return PIPELINES[full]


def _observed(entry, argv, configure_all: bool, checked):
    """``entry(argv)`` with ``--trace``, ``--profiles``, ``--aot-cache`` and
    ``--check`` taken out of ``argv`` and applied, the trace written at the end either way.
    With ``configure_all`` (the command line) logging and phase profiling
    are set up too; a caller of :func:`run` keeps its own. Under
    ``--check`` the first fit stops at its static check: the report's
    summary is printed and ``checked(report)`` returned."""
    from . import check as check_mod
    from . import compile as compile_mod
    from . import cost
    from .obs import tracer as obs_tracer
    from .utils.obs import configure, export_trace

    flags = _with_flags(argparse.ArgumentParser(add_help=False, allow_abbrev=False))
    args, rest = flags.parse_known_args(argv)
    # the application's own --device keys the profile store's environment
    device = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    device.add_argument("--device", default=None)
    device = device.parse_known_args(rest)[0].device
    if configure_all:
        configure(args.log_level, profile=args.profile or None, trace=args.trace,
                  profiles=args.profiles, device=device, aot_cache=args.aot_cache)
    else:
        if args.trace:
            obs_tracer.start(path=args.trace)
        if args.profiles is not None:
            cost.configure(args.profiles, device=device)
        if args.aot_cache is not None:
            compile_mod.configure(args.aot_cache)
    if args.check_only:
        check_mod.set_check_only(True)
    try:
        return entry(rest)
    except check_mod.CheckOnlyExit as e:
        if not args.check_only:
            raise
        s = e.report.summary()
        print(f"CHECK OK: {s['nodes']} nodes, {s['segments']} segment(s), "
              f"{s['barriers']} barrier(s), 0 executions", flush=True)
        return checked(e.report)
    finally:
        if args.check_only:
            # an in-process caller's later fits must not stop at a check
            check_mod.set_check_only(False)
        export_trace()


def run(argv) -> dict:
    """Run an application and return its result dict (under ``--check``,
    ``{"check_report": report}``). Only ``--trace``, ``--profiles``,
    ``--aot-cache`` and ``--check`` are configured here: logging and phase profiling stay the
    caller's."""
    argv = list(argv)
    return _observed(_app(argv)[0], argv, configure_all=False,
                     checked=lambda report: {"check_report": report})


def _demo_main(flag: str):
    if flag == "--serve-demo":
        from .serving.demo import main
    elif flag == "--sweep-demo":
        from .sweep.demo import main
    else:
        from .trainer.demo import main
    return main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    demos = [f for f in map(demo_flag, argv) if f is not None]
    if demos:
        argv = [a for a in argv if demo_flag(a) is None]
        _parser(demo=True).parse_known_args(argv)  # argparse's errors, as without a demo
        return _observed(_demo_main(demos[0]), argv, configure_all=True, checked=lambda _: 0)
    return _observed(_app(argv)[1], argv, configure_all=True, checked=lambda _: 0)


if __name__ == "__main__":
    raise SystemExit(main())
