"""String preprocessing (port of ``keystone_tpu/nodes/nlp/text.py``;
parity: ``nodes/nlp/StringUtils.scala:13-33``): Tokenizer, Trim and
LowerCase. Strings are host data, so each is a per-item transformer; the
device boundary comes later, at the sparse vectorizer."""

from __future__ import annotations

import re

from ...workflow.transformer import Transformer


class Tokenizer(Transformer):
    """Split on a delimiting regex, by default the reference's punctuation
    and whitespace class. Java's ``String.split`` drops trailing empty
    tokens but keeps a leading one when the string starts with a
    separator; so does this."""

    def __init__(self, sep: str = r"[^\w]+"):
        self.sep = sep
        self._re = re.compile(sep)

    def apply(self, x: str):
        parts = self._re.split(x)
        while parts and parts[-1] == "":
            parts.pop()
        return parts

    def __getstate__(self):
        return {"sep": self.sep}

    def __setstate__(self, state):
        self.sep = state["sep"]
        self._re = re.compile(self.sep)


class Trim(Transformer):
    """Strip leading and trailing whitespace."""

    def apply(self, x: str) -> str:
        return x.strip()


class LowerCase(Transformer):
    """Lower-case."""

    def apply(self, x: str) -> str:
        return x.lower()
