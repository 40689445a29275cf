"""Leveled message log with recent-message ring.

Reference: src/core/log.h:16 — leveled printf-style log capturing
file/function/line, displayed in an on-screen fade-out window.  Here: stdlib
logging underneath + an in-memory ring of recent messages for dashboards (the
fade-window equivalent).
"""

from __future__ import annotations

import collections
import inspect
import logging
import time
from typing import Deque, List, NamedTuple

LOG_RING_SIZE = 64

_logger = logging.getLogger("d3d12renderer_jax")
if not _logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-7s %(message)s", "%H:%M:%S"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)


class LogEntry(NamedTuple):
    level: str
    message: str
    origin: str
    timestamp: float


_ring: Deque[LogEntry] = collections.deque(maxlen=LOG_RING_SIZE)


def _origin() -> str:
    # stack: [_origin, _log, log_<level>, caller]
    frame = inspect.stack()[3]
    return f"{frame.filename.split('/')[-1]}:{frame.lineno}"


def _log(level: str, fn, msg: str, *args):
    text = msg % args if args else msg
    entry = LogEntry(level, text, _origin(), time.time())
    _ring.append(entry)
    fn(f"[{entry.origin}] {text}")


def log_debug(msg, *args):
    _log("debug", _logger.debug, msg, *args)


def log_info(msg, *args):
    _log("info", _logger.info, msg, *args)


def log_warning(msg, *args):
    _log("warning", _logger.warning, msg, *args)


def log_error(msg, *args):
    _log("error", _logger.error, msg, *args)


def recent_messages(n: int = LOG_RING_SIZE) -> List[LogEntry]:
    """The on-screen-window equivalent: most recent messages."""
    return list(_ring)[-n:]


def set_level(level: str):
    _logger.setLevel(getattr(logging, level.upper()))
