"""Logger + timing utilities (reference src/core/logger.hpp, timer.hpp).

Uses Python logging with the reference's severity levels; asserts stay on
in production per the reference's ship-with-asserts posture
(reference CMakeLists.txt:28-34 strips -DNDEBUG)."""

from __future__ import annotations

import logging
import sys
import time

_LOG = logging.getLogger("powerserve_tpu_torch")
if not _LOG.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("[%(levelname).1s] %(message)s"))
    _LOG.addHandler(h)
    _LOG.setLevel(logging.INFO)


def get_logger(name: str | None = None) -> logging.Logger:
    return _LOG.getChild(name) if name else _LOG


def timestamp_ms() -> float:
    """Monotonic ms (reference src/core/timer.hpp:23)."""
    return time.perf_counter() * 1e3


class Timer:
    """Reference src/core/timer.hpp:25-48."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed_time_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3
