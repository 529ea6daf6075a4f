"""Leveled ANSI console logger.

Copy of ``elaina_tpu/core/logger.py`` (reference: core/logger.{h,cpp}).
"""

from __future__ import annotations

import sys
import time

_COLORS = {
    "debug": "\033[90m",
    "info": "\033[0m",
    "success": "\033[32m",
    "warning": "\033[33m",
    "error": "\033[31m",
    "fatal": "\033[1;31m",
}
_RESET = "\033[0m"

_LEVELS = ["debug", "info", "success", "warning", "error", "fatal"]
_min_level = "info"


def set_level(level: str) -> None:
    global _min_level
    _min_level = level


def log(level: str, msg: str, *args) -> None:
    if _LEVELS.index(level) < _LEVELS.index(_min_level):
        return
    if args:
        msg = msg % args
    ts = time.strftime("%H:%M:%S")
    color = _COLORS.get(level, "")
    stream = sys.stderr if level in ("error", "fatal") else sys.stdout
    print(f"{color}[{ts} {level.upper():7s}] {msg}{_RESET}", file=stream)
    if level == "fatal":
        raise SystemExit(1)


def log_debug(msg, *args):
    log("debug", msg, *args)


def log_info(msg, *args):
    log("info", msg, *args)


def log_success(msg, *args):
    log("success", msg, *args)


def log_warning(msg, *args):
    log("warning", msg, *args)


def log_error(msg, *args):
    log("error", msg, *args)
