"""StupidBackoffPipeline (port of
``keystone_tpu/pipelines/stupid_backoff_pipeline.py``): an n-gram language
model, Tokenizer → WordFrequencyEncoder (ids by frequency rank) →
NGramsFeaturizer(2..n) over the ids → NGramsCounts(noAdd) →
StupidBackoffEstimator(unigram counts). It prints the corpus's statistics
and scores of its n-grams, as the reference's main program does. The model is
host numpy, as in the JAX package: it has no device version, and so no
``--device`` flag.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..data.dataset import Dataset
from ..nodes.nlp import (
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    StupidBackoffModel,
    Tokenizer,
    WordFrequencyEncoder,
    WordFrequencyTransformer,
)


def train_language_model(lines, n: int = 3) -> StupidBackoffModel:
    """Raw text lines → a fitted StupidBackoffModel over frequency-encoded
    word ids."""
    corpus = Dataset.from_items(list(lines))
    # the encoder is fitted through a pipeline, so ``--check`` stops at its
    # fit and reports the tokenizer and encoder
    encoder = Tokenizer().and_then(WordFrequencyEncoder(), corpus).fit()
    frequency_encode = next(op for op in encoder.graph.operators.values()
                            if isinstance(op, WordFrequencyTransformer))
    encoded = encoder.apply(corpus)
    featurizer = NGramsFeaturizer(list(range(2, n + 1)))
    ngram_counts = NGramsCounts("noadd").apply_batch(
        Dataset.from_items([featurizer.apply(doc) for doc in encoded]))
    return StupidBackoffEstimator(frequency_encode.unigram_counts).fit(ngram_counts)


def synthetic_corpus(n_lines: int = 200, seed: int = 0):
    """The JAX package's synthetic corpus, the same numpy draws: lines of
    Zipf-distributed words, so frequency ranks are not trivial."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(60)]
    lines = []
    for _ in range(n_lines):
        ln = rng.integers(4, 14)
        ids = np.minimum(rng.zipf(1.5, size=ln) - 1, len(vocab) - 1).astype(int)
        lines.append(" ".join(vocab[i] for i in ids))
    return lines


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("StupidBackoffPipeline")
    p.add_argument("app", choices=["StupidBackoffPipeline"])
    p.add_argument("--trainData", default=None)
    p.add_argument("--n", type=int, default=3)
    return p.parse_args(argv)


def run_app(argv=None) -> dict:
    """Parse the command line and fit the model; without ``--trainData`` on
    ``synthetic_corpus()``, as the JAX CLI does. Returns the model and the
    seconds."""
    args = parse_args(argv)
    if args.trainData:
        with open(args.trainData) as f:
            lines = [ln.rstrip("\n") for ln in f]
    else:
        lines = synthetic_corpus()
    t0 = time.perf_counter()
    lm = train_language_model(lines, n=args.n)
    return {"model": lm, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    out = run_app(argv)
    lm = out["model"]
    print(f"number of tokens: {lm.num_tokens}")
    print(f"size of vocabulary: {len(lm.unigram_counts)}")
    print(f"number of ngrams: {len(lm.scores)}")
    print("trained scores of 100 ngrams in the corpus:")
    for ngram, score in list(lm.scores.items())[:100]:
        print(ngram, score)
    print(f"Pipeline took {out['seconds']} s")
    return 0
