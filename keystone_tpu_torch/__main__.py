"""Command line: ``python -m keystone_tpu_torch <App> [--device cpu] ...``.

The port runs the JAX package's twelve applications, with the flags of its
CLI: the CIFAR family (RandomPatchCifar, LinearPixels, RandomCifar,
RandomPatchCifarAugmented, RandomPatchCifarKernel), MnistRandomFFT,
TimitPipeline, VOCSIFTFisher, ImageNetSiftLcsFV, NewsgroupsPipeline,
AmazonReviewsPipeline and StupidBackoffPipeline. Each runs on CUDA unless
``--device cpu`` is given, but StupidBackoffPipeline, whose language model
is host numpy.
"""

from __future__ import annotations

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


def run(argv) -> dict:
    """Run an application and return its result dict."""
    return _app(argv)[0](argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return _app(argv)[1](argv)


if __name__ == "__main__":
    raise SystemExit(main())
