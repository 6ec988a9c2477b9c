"""Command line: ``python -m keystone_tpu_torch <App> [--device cpu] ...``.

The port runs the JAX package's twelve applications, with the flags of its
CLI: the CIFAR family (RandomPatchCifar, LinearPixels, RandomCifar,
RandomPatchCifarAugmented, RandomPatchCifarKernel), MnistRandomFFT,
TimitPipeline, VOCSIFTFisher, ImageNetSiftLcsFV, NewsgroupsPipeline,
AmazonReviewsPipeline and StupidBackoffPipeline. Each runs on CUDA unless
``--device cpu`` is given, but StupidBackoffPipeline, whose language model
is host numpy.

Two flags of the JAX CLI apply to every application: ``--trace PATH``
records a per-node trace and writes it as Chrome-trace JSON to ``PATH``
when the application ends, failed or not (also ``KEYSTONE_TRACE``), and
``--profiles DIR`` keeps the operator-profile store in ``DIR``, from which
the second fit of a pipeline plans its solver choice and caching with zero
sampling executions (also ``KEYSTONE_PROFILE_DIR``). The JAX CLI's
``--check``, ``--aot-cache`` and demo modes come with their modules.
"""

from __future__ import annotations

import argparse
import sys

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


def _app(argv):
    if not argv or argv[0] not in PIPELINES:
        raise SystemExit(
            f"usage: python -m keystone_tpu_torch {{{','.join(PIPELINES)}}} [flags]"
        )
    return PIPELINES[argv[0]]


def _observed(entry, argv, configure_all: bool):
    """``entry(argv)`` with ``--trace`` and ``--profiles`` taken out of
    ``argv`` and applied, the trace written at the end either way. With
    ``configure_all`` (the command line) logging and phase profiling are
    set up too; a caller of :func:`run` keeps its own."""
    from . import cost
    from .obs import tracer as obs_tracer
    from .utils.obs import configure, export_trace

    flags = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    flags.add_argument("--trace", default=None, metavar="PATH")
    flags.add_argument("--profiles", default=None, metavar="DIR")
    args, rest = flags.parse_known_args(argv)
    # the application's own --device keys the profile store's environment
    device = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    device.add_argument("--device", default=None)
    device = device.parse_known_args(rest)[0].device
    if configure_all:
        configure(trace=args.trace, profiles=args.profiles, device=device)
    else:
        if args.trace:
            obs_tracer.start(path=args.trace)
        if args.profiles is not None:
            cost.configure(args.profiles, device=device)
    try:
        return entry(rest)
    finally:
        export_trace()


def run(argv) -> dict:
    """Run an application and return its result dict. Only ``--trace`` and
    ``--profiles`` are configured here: logging and phase profiling stay
    the caller's."""
    argv = list(argv)
    return _observed(_app(argv)[0], argv, configure_all=False)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return _observed(_app(argv)[1], argv, configure_all=True)


if __name__ == "__main__":
    raise SystemExit(main())
