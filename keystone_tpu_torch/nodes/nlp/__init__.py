"""Text nodes (port of ``keystone_tpu/nodes/nlp``): string preprocessing,
n-grams, feature hashing, the packed-gram indexers and featurizer, the word
frequency encoder, the Stupid Backoff language model and the dependency-free
CoreNLP feature extractor (``corenlp_lite.py``), which no application runs."""

from .corenlp_lite import CoreNLPFeatureExtractor, lemmatize
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
    "CoreNLPFeatureExtractor", "lemmatize",
    "HashingTF", "NGramsHashingTF", "java_string_hash", "murmur3_seq_hash", "scala_hash",
    "NaiveBitPackIndexer", "NGramIndexerImpl", "NGramsCounts", "NGramsFeaturizer",
    "PackedTextFeatures", "PackedTextVectorizer", "WordFrequencyEncoder",
    "WordFrequencyTransformer", "PackedStupidBackoffModel", "StupidBackoffEstimator",
    "StupidBackoffModel", "score_stupid_backoff", "LowerCase", "Tokenizer", "Trim",
]
