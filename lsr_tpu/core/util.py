"""Core engine utilities: logging, Result, frame clock, SI units.

Analogs of core/log.hpp:18-33 (log_info/warn/error to stdout/stderr),
core/result.hpp:19 (Result value type), core/time.hpp:17 (FrameClock) and
core/units.hpp:22-66 (SI constants; 1.0 world unit = 1 meter,
conventions.md §1).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Generic, Optional, TypeVar

T = TypeVar("T")

# --- units (core/units.hpp) --------------------------------------------------

METER = 1.0
KILOMETER = 1000.0
CENTIMETER = 0.01
MILLIMETER = 0.001
SECOND = 1.0
MILLISECOND = 1e-3
GRAVITY = (0.0, -9.81, 0.0)  # -Y down, 9.81 m/s^2 (conventions.md §1)


def meters(x: float) -> float:
    return x * METER


def cdiv(a: int, b: int) -> int:
    """Ceiling division of static sizes."""
    return -(-a // b)


# --- logging (core/log.hpp) --------------------------------------------------

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}
_min_level = "info"


def set_log_level(level: str) -> None:
    global _min_level
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level}")
    _min_level = level


def _log(level: str, msg: str) -> None:
    if _LEVELS[level] < _LEVELS[_min_level]:
        return
    stream = sys.stderr if level in ("warn", "error") else sys.stdout
    print(f"[lsr:{level}] {msg}", file=stream)


def log_debug(msg: str) -> None:
    _log("debug", msg)


def log_info(msg: str) -> None:
    _log("info", msg)


def log_warn(msg: str) -> None:
    _log("warn", msg)


def log_error(msg: str) -> None:
    _log("error", msg)


# --- Result (core/result.hpp) ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Result(Generic[T]):
    """Value-or-error; errors are strings (the reference's Result pattern)."""

    value: Optional[T] = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error

    @staticmethod
    def success(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def failure(error: str) -> "Result[T]":
        return Result(error=error or "unknown error")

    def unwrap(self) -> T:
        if not self.ok:
            raise RuntimeError(f"Result.unwrap on error: {self.error}")
        return self.value


# --- FrameClock (core/time.hpp) ----------------------------------------------

class FrameClock:
    """Wall-clock frame timing: dt, total time, frame counter, FPS average."""

    def __init__(self, now_fn=time.perf_counter):
        self._now = now_fn
        self._last = now_fn()
        self._start = self._last
        self.dt = 0.0
        self.time = 0.0
        self.frame = 0

    def tick(self) -> float:
        now = self._now()
        self.dt = now - self._last
        self._last = now
        self.time = now - self._start
        self.frame += 1
        return self.dt

    def fps(self) -> float:
        return self.frame / self.time if self.time > 0 else 0.0
