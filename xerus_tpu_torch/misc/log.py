"""Named logger with per-channel levels.

Equivalent of the reference's compile-time-filtered named logger
(include/xerus/misc/namedLogger.h, tensorLogger.h:29-37) using stdlib logging
with runtime-settable levels per channel.
"""

from __future__ import annotations

import logging

_ROOT = "xerus_tpu_torch"

logging.getLogger(_ROOT).addHandler(logging.NullHandler())


def get_logger(channel: str = "") -> logging.Logger:
    name = f"{_ROOT}.{channel}" if channel else _ROOT
    return logging.getLogger(name)


def set_log_level(level, channel: str = "") -> None:
    get_logger(channel).setLevel(level)


class RingBufferHandler(logging.Handler):
    """LOGGING_ON_ERROR analogue (namedLogger.h:115-160): keep the last
    `capacity` records in memory and flush them to `target` only when a
    record at ERROR or above arrives — the context of a failure without
    the cost of always-on logging."""

    def __init__(self, capacity: int = 512, target: logging.Handler = None):
        super().__init__(level=logging.DEBUG)
        from collections import deque
        self._buf = deque(maxlen=capacity)
        self._target = target or logging.StreamHandler()

    def emit(self, record: logging.LogRecord) -> None:
        self._buf.append(record)
        if record.levelno >= logging.ERROR:
            for rec in self._buf:
                self._target.emit(rec)
            self._buf.clear()

    def dump(self) -> list:
        """Return (and keep) the buffered records, e.g. for inspection."""
        return list(self._buf)


def enable_log_on_error(capacity: int = 512,
                        target: logging.Handler = None) -> RingBufferHandler:
    """Install a RingBufferHandler on the root xerus_tpu_torch logger and lower
    its level so all records are buffered.  Returns the handler."""
    h = RingBufferHandler(capacity, target)
    root = get_logger()
    root.addHandler(h)
    root.setLevel(logging.DEBUG)
    return h


def log(msg) -> None:
    """`xe.log(msg)` — the reference's Python `log` binding
    (python/misc.cpp:67-70): emit an info-level message through the
    library logger."""
    get_logger("info").info("%s", msg)
