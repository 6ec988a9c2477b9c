"""Cached constant tensors that the static checker cannot poison."""

from __future__ import annotations

import functools
from typing import Callable


def _fake_mode_active() -> bool:
    """Is a ``FakeTensorMode`` (the static checker's abstract evaluation)
    active on this thread?"""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def device_constant(fn: Callable) -> Callable:
    """``functools.lru_cache(maxsize=None)`` for a function that builds
    constant tensors (index tables, filter taps) on a device. Under the
    static checker's fake mode the tensors are built anew and not cached:
    a cached fake tensor would hand a later real run no data, and a real
    one built by a check would allocate on the card."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        if _fake_mode_active():
            return fn(*args)
        return cached(*args)

    wrapper.cache_clear = cached.cache_clear
    return wrapper
