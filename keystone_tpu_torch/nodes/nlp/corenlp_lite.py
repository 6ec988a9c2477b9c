"""CoreNLPFeatureExtractor, dependency-free (port of
``keystone_tpu/nodes/nlp/corenlp_lite.py``; parity interface:
``CoreNLPFeatureExtractor.scala``): a document becomes the n-grams of its
sentences, lemmatized, with named entities replaced by their type and the
other tokens normalized (non-alphanumerics stripped, lowercased).

The JAX package keeps the reference's feature contract without an NLP
stack, and so does the port, with its own copy of the rules:

* a suffix-rule lemmatizer (plural -s/-es/-ies, -ing, -ed with consonant
  doubling and e-restoration) and a table of irregular lemmas;
* a gazetteer NER for PERSON and LOCATION (given names; countries, US
  states, large cities): an entity becomes its type token;
* sentences split on .!?, each with its own n-grams, so no gram crosses a
  sentence boundary.

Pure Python on the host: no tensor is involved.
"""

from __future__ import annotations

import re
from typing import List, Sequence

from ...workflow.transformer import Transformer

_VOWELS = set("aeiou")

#: irregular lemmas the suffix rules can't reach (small, extensible)
_IRREGULAR = {
    "ran": "run", "went": "go", "men": "man", "women": "woman",
    "children": "child", "feet": "foot", "mice": "mouse", "geese": "goose",
    "teeth": "tooth", "better": "good", "was": "be", "were": "be",
    "is": "be", "are": "be", "has": "have", "had": "have", "said": "say",
    "made": "make", "took": "take", "came": "come", "saw": "see",
    "got": "get", "gave": "give", "found": "find", "knew": "know",
    "thought": "think", "people": "person",
}

#: tiny gazetteers for the two entity types the reference suite exercises
_PERSON_NAMES = {
    "john", "mary", "james", "robert", "michael", "william", "david",
    "richard", "joseph", "thomas", "charles", "jon", "sarah", "emily",
    "anna", "peter", "paul", "george", "susan", "linda", "karen", "nancy",
    "jennifer", "elizabeth", "alice", "bob", "carol", "dave", "eve",
}
_LOCATIONS = {
    # US states
    "alabama", "alaska", "arizona", "arkansas", "california", "colorado",
    "connecticut", "delaware", "florida", "georgia", "hawaii", "idaho",
    "illinois", "indiana", "iowa", "kansas", "kentucky", "louisiana",
    "maine", "maryland", "massachusetts", "michigan", "minnesota",
    "mississippi", "missouri", "montana", "nebraska", "nevada", "ohio",
    "oklahoma", "oregon", "pennsylvania", "tennessee", "texas", "utah",
    "vermont", "virginia", "washington", "wisconsin", "wyoming",
    # countries / cities commonly hit in the datasets
    "america", "england", "france", "germany", "china", "japan", "india",
    "canada", "mexico", "brazil", "russia", "spain", "italy", "egypt",
    "paris", "london", "berlin", "tokyo", "boston", "chicago", "seattle",
    "houston", "denver", "miami", "atlanta", "dallas",
}


def _ends_cvc(s: str) -> bool:
    """consonant-vowel-consonant ending (Porter's *o condition) — the
    e-restoration heuristic: 'mak' → 'make', but 'jump' stays."""
    if len(s) < 3:
        return False
    c1, v, c2 = s[-3], s[-2], s[-1]
    return (
        c1 not in _VOWELS
        and v in _VOWELS
        and c2 not in _VOWELS
        and c2 not in "wxy"
    )


def lemmatize(word: str) -> str:
    """Rule-based lemma of a lowercase token."""
    w = word
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if len(w) <= 3:
        return w

    # plural / 3rd-person -s family
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith(("sses", "ches", "shes", "xes", "zes")):
        return w[:-2]
    if w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1]

    for suffix in ("ing", "ed"):
        if w.endswith(suffix) and len(w) - len(suffix) >= 2:
            stem = w[: -len(suffix)]
            if not any(ch in _VOWELS for ch in stem):
                continue  # e.g. "sing", "red": suffix is not a suffix
            # consonant doubling: running → run, stopped → stop
            if (
                len(stem) >= 3
                and stem[-1] == stem[-2]
                and stem[-1] not in _VOWELS
                and stem[-1] not in "lsz"
            ):
                return stem[:-1]
            # e-restoration: making → make, hoped → hope
            if _ends_cvc(stem):
                return stem + "e"
            return stem
    return w


_NORMALIZE_RE = re.compile(r"[^a-zA-Z0-9\s+]")


def _normalize(s: str) -> str:
    """parity: CoreNLPFeatureExtractor.normalize (strip non-alphanumerics,
    lowercase)."""
    return _NORMALIZE_RE.sub("", s).lower()


_SENTENCE_RE = re.compile(r"[.!?]+")
_TOKEN_RE = re.compile(r"[A-Za-z0-9']+")


class CoreNLPFeatureExtractor(Transformer):
    """doc string → lemmatized/entity-substituted n-grams
    (parity interface: CoreNLPFeatureExtractor(orders))."""

    def __init__(self, orders: Sequence[int]):
        self.orders = list(orders)

    def _sentence_tokens(self, sentence: str) -> List[str]:
        out = []
        for tok in _TOKEN_RE.findall(sentence):
            low = tok.lower()
            if low in _PERSON_NAMES:
                out.append("PERSON")
            elif low in _LOCATIONS:
                out.append("LOCATION")
            else:
                out.append(_normalize(lemmatize(low)))
        return [t for t in out if t]

    def apply(self, doc: str) -> List[str]:
        sentences = [
            s for s in _SENTENCE_RE.split(doc) if s.strip()
        ]
        token_lists = [self._sentence_tokens(s) for s in sentences]
        grams: List[str] = []
        for n in self.orders:
            for toks in token_lists:
                for i in range(len(toks) - n + 1):
                    grams.append(" ".join(toks[i : i + n]))
        return grams
