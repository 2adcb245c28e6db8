"""Leveled, rank-prefixed logging (counterpart of ``horovod_tpu/utils/logging.py``).

Reference: ``horovod/common/logging.{h,cc}``; the level comes from
``HVDTPU_LOG_LEVEL`` ∈ {debug, info, warning, error, fatal, off}.
"""

from __future__ import annotations

import logging as _pylogging
import sys

from . import envvars as ev

_LEVELS = {
    "debug": _pylogging.DEBUG,
    "info": _pylogging.INFO,
    "warning": _pylogging.WARNING,
    "error": _pylogging.ERROR,
    "fatal": _pylogging.CRITICAL,
    "off": _pylogging.CRITICAL + 10,
}


def _make_logger() -> _pylogging.Logger:
    logger = _pylogging.getLogger("horovod_tpu_torch")
    if not logger.handlers:
        handler = _pylogging.StreamHandler(sys.stderr)
        handler.setFormatter(_pylogging.Formatter(
            "%(asctime)s [%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        level_name = (ev.get_str(ev.HVDTPU_LOG_LEVEL) or "warning").lower()
        logger.setLevel(_LEVELS.get(level_name, _pylogging.WARNING))
        logger.propagate = False
    return logger


logger = _make_logger()


def _prefix(msg: str) -> str:
    # Rank prefix, like the reference's "[<rank>]:" (logging.cc LogMessage).
    rank = ev.get_str(ev.HVDTPU_RANK) or ev.get_str(ev.RANK)
    return f"[{rank}]: {msg}" if rank is not None else msg


def debug(msg: str, *args) -> None:
    logger.debug(_prefix(msg), *args)


def warning(msg: str, *args) -> None:
    logger.warning(_prefix(msg), *args)


def info(msg: str, *args) -> None:
    logger.info(_prefix(msg), *args)
