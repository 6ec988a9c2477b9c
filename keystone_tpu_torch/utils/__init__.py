"""Shared helpers: the readers of the ``KEYSTONE_*`` switches (the port's
copy of ``keystone_tpu/utils/__init__.py::env_flag``, ``env_int``, ``env_float``
and ``env_str``)."""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

#: (name, raw) pairs already warned about: a bad value is logged once
_warned_env: set = set()


def env_flag(name: str, default: bool = True) -> bool:
    """A ``KEYSTONE_*`` on/off switch: unset gives ``default``;
    0/false/no/off (any case) give False, anything else True."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """A ``KEYSTONE_*`` integer: unset or unparsable gives ``default`` (an
    unparsable value is warned about once); a parsed value is clamped to
    ``minimum``."""
    raw = os.environ.get(name)
    if raw is not None:
        try:
            return max(minimum, int(raw))
        except ValueError:
            if (name, raw) not in _warned_env:
                _warned_env.add((name, raw))
                logger.warning("%s=%r is not an integer; using %d", name, raw, default)
    return default


def env_float(name: str, default: float, minimum: float = 0.0) -> float:
    """A ``KEYSTONE_*`` float: unset or unparsable gives ``default`` (an
    unparsable value is warned about once); a parsed value is clamped to
    ``minimum``."""
    raw = os.environ.get(name)
    if raw is not None:
        try:
            return max(minimum, float(raw))
        except ValueError:
            if (name, raw) not in _warned_env:
                _warned_env.add((name, raw))
                logger.warning("%s=%r is not a number; using %s", name, raw, default)
    return default


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """A ``KEYSTONE_*`` string (a path, a spec): unset or blank gives
    ``default``, so ``KEYSTONE_X=`` means off rather than an empty path."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    raw = raw.strip()
    return raw if raw else default
