"""Text nodes (port of ``keystone_tpu/nodes/nlp``): string preprocessing,
n-grams, feature hashing, the packed-gram indexers and featurizer, the word
frequency encoder and the Stupid Backoff language model. CoreNLP's feature
extractor (``corenlp_lite.py``) is not ported: no application runs it."""

from .hashing import HashingTF, NGramsHashingTF, java_string_hash, murmur3_seq_hash, scala_hash
from .indexers import NaiveBitPackIndexer, NGramIndexerImpl
from .ngrams import NGramsCounts, NGramsFeaturizer, WordFrequencyEncoder, WordFrequencyTransformer
from .packed_features import PackedTextFeatures, PackedTextVectorizer
from .stupid_backoff import (
    PackedStupidBackoffModel,
    StupidBackoffEstimator,
    StupidBackoffModel,
    score_stupid_backoff,
)
from .text import LowerCase, Tokenizer, Trim

__all__ = [
    "HashingTF", "NGramsHashingTF", "java_string_hash", "murmur3_seq_hash", "scala_hash",
    "NaiveBitPackIndexer", "NGramIndexerImpl", "NGramsCounts", "NGramsFeaturizer",
    "PackedTextFeatures", "PackedTextVectorizer", "WordFrequencyEncoder",
    "WordFrequencyTransformer", "PackedStupidBackoffModel", "StupidBackoffEstimator",
    "StupidBackoffModel", "score_stupid_backoff", "LowerCase", "Tokenizer", "Trim",
]
