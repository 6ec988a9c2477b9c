"""Packed n-gram indexers (port of ``keystone_tpu/nodes/nlp/indexers.py``;
parity: ``nodes/nlp/indexers.scala:49-140``). NaiveBitPackIndexer packs up
to three word ids into one int64, so a corpus of n-grams is a flat integer
array; each operation exists per n-gram and vectorized over numpy int64
arrays."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_WORD_BITS = 20
_WORD_MASK = (1 << _WORD_BITS) - 1


class NaiveBitPackIndexer:
    """Up to 3 word ids (each < 2²⁰) in one int64. Layout, most significant
    first: [4 control bits][farthest word][middle][current], left-aligned;
    control 00 = unigram, 01 = bigram, 10 = trigram."""

    min_ngram_order = 1
    max_ngram_order = 3

    @staticmethod
    def pack(ngram: Sequence[int]) -> int:
        for w in ngram:
            if w >= (1 << _WORD_BITS) or w < 0:
                # a negative id (the −1 OOV sentinel) would sign-extend into
                # the control bits and corrupt the packed order
                raise ValueError(f"word id {w} outside [0, 2^20)")
        n = len(ngram)
        if n == 1:
            return ngram[0] << 40
        if n == 2:
            return (ngram[1] << 20) | (ngram[0] << 40) | (1 << 60)
        if n == 3:
            return ngram[2] | (ngram[1] << 20) | (ngram[0] << 40) | (1 << 61)
        raise ValueError("ngram order need to be in { 1, 2, 3 } for now")

    @staticmethod
    def unpack(ngram: int, pos: int) -> int:
        if pos == 0:
            return (ngram >> 40) & _WORD_MASK
        if pos == 1:
            return (ngram >> 20) & _WORD_MASK
        if pos == 2:
            return ngram & _WORD_MASK
        raise ValueError("ngram order need to be in { 1, 2, 3 } for now")

    @classmethod
    def ngram_order(cls, ngram: int) -> int:
        order = (ngram >> 60) & 0xF
        if not (cls.min_ngram_order <= order + 1 <= cls.max_ngram_order):
            raise ValueError(f"raw control bits {order} are invalid")
        return order + 1

    @classmethod
    def remove_farthest_word(cls, ngram: int) -> int:
        order = cls.ngram_order(ngram)
        shifted = (ngram & ((1 << 40) - 1)) << 20
        if order == 2:
            return shifted  # a unigram (control 00)
        if order == 3:
            return shifted | (1 << 60)  # a bigram
        raise ValueError(f"ngram order is either invalid or not supported: {order}")

    @classmethod
    def remove_current_word(cls, ngram: int) -> int:
        order = cls.ngram_order(ngram)
        if order == 2:
            return ngram & ~((1 << 40) - 1) & ~(0xF << 60)
        if order == 3:
            return (ngram & ~(_WORD_MASK) & ~(0xF << 60)) | (1 << 60)
        raise ValueError(f"ngram order is either invalid or not supported: {order}")

    # -- vectorized forms ------------------------------------------------

    @staticmethod
    def pack_batch(words: np.ndarray, order: int) -> np.ndarray:
        """(n, order) word ids → (n,) packed int64. Unlike :meth:`pack`,
        ids are not range-checked: the packed-features apply streams the −1
        OOV sentinel through, and a gram holding it packs negative, so it
        can never equal a real (non-negative) key. Callers building a table
        check ids themselves, as PackedStupidBackoffModel.from_model does."""
        words = np.asarray(words, dtype=np.int64)
        if order == 1:
            return words[:, 0] << 40
        if order == 2:
            return (words[:, 1] << 20) | (words[:, 0] << 40) | (1 << 60)
        if order == 3:
            return words[:, 2] | (words[:, 1] << 20) | (words[:, 0] << 40) | (1 << 61)
        raise ValueError("order must be in {1, 2, 3}")

    @staticmethod
    def unpack_batch(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n,) packed → ((n, 3) word ids, (n,) orders)."""
        packed = np.asarray(packed, dtype=np.int64)
        orders = ((packed >> 60) & 0xF) + 1
        words = np.stack([(packed >> 40) & _WORD_MASK, (packed >> 20) & _WORD_MASK,
                          packed & _WORD_MASK], axis=1)
        return words, orders

    @staticmethod
    def order_batch(packed: np.ndarray) -> np.ndarray:
        """(n,) packed → (n,) orders (control bits + 1)."""
        return ((np.asarray(packed, dtype=np.int64) >> 60) & 0xF) + 1

    @staticmethod
    def farthest_word_batch(packed: np.ndarray) -> np.ndarray:
        """(n,) packed → (n,) word id at position 0."""
        return (np.asarray(packed, dtype=np.int64) >> 40) & _WORD_MASK

    @staticmethod
    def remove_current_word_batch(q: np.ndarray, orders: np.ndarray) -> np.ndarray:
        """:meth:`remove_current_word` over arrays, for orders 2 and 3 (other
        entries get unspecified values; callers mask them)."""
        lo40 = np.int64((1 << 40) - 1)
        ctrl = np.int64(0xF) << np.int64(60)
        bigram_to_uni = q & ~lo40 & ~ctrl
        trigram_to_bi = (q & ~np.int64(_WORD_MASK) & ~ctrl) | (np.int64(1) << np.int64(60))
        return np.where(orders == 2, bigram_to_uni, trigram_to_bi)

    @staticmethod
    def remove_farthest_word_batch(q: np.ndarray, orders: np.ndarray) -> np.ndarray:
        """:meth:`remove_farthest_word` over arrays, for orders 2 and 3."""
        shifted = (q & np.int64((1 << 40) - 1)) << np.int64(20)
        return np.where(orders == 2, shifted, shifted | (np.int64(1) << np.int64(60)))


class NGramIndexerImpl:
    """Tuple n-grams of any order up to 5."""

    min_ngram_order = 1
    max_ngram_order = 5

    @staticmethod
    def pack(ngram: Sequence) -> tuple:
        return tuple(ngram)

    @staticmethod
    def unpack(ngram: tuple, pos: int):
        return ngram[pos]

    @staticmethod
    def remove_farthest_word(ngram: tuple) -> tuple:
        return tuple(ngram[1:])

    @staticmethod
    def remove_current_word(ngram: tuple) -> tuple:
        return tuple(ngram[:-1])

    @staticmethod
    def ngram_order(ngram: tuple) -> int:
        return len(ngram)
