"""Structured, leveled logging attached to an ambient context
(``oim_tpu/common/logging.py``, copied).

``with_logger()`` installs a logger for the current thread or async
context and ``from_context()`` retrieves it, falling back to the global
logger; ``Logger.with_fields`` binds key/value pairs (the RPC telemetry
interceptors bind ``trace_id``). Lines are ``<time> <level> <msg> | k: v``,
or one JSON object per line.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import sys
import threading
import time
from typing import Any, Iterator, TextIO

DEBUG, INFO, WARNING, ERROR = 10, 20, 30, 40

FORMATS = ("text", "json")


def _timestamp() -> str:
    """Wall clock with millisecond precision — sub-second ordering matters
    when correlating log lines against span timelines."""
    now = time.time()
    return (time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now))
            + ".%03d" % (int(now * 1000) % 1000))

_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARNING: "WARNING", ERROR: "ERROR"}
_NAME_LEVELS = {v.lower(): k for k, v in _LEVEL_NAMES.items()}


def parse_level(name: str) -> int:
    """Parse a level name ('debug'..'error'), mirroring pkg/log/level/level.go."""
    try:
        return _NAME_LEVELS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown log level: {name!r}") from None


class Logger:
    """A leveled, structured logger with immutable bound fields.

    ``with_fields`` returns a child logger carrying extra key/value pairs
    (reference Logger.With, pkg/log/log.go:37-110). Output formatting follows
    the reference's simple logger: ``<time> <level> <msg> | k: v``
    (pkg/log/formatter.go:18-30) — or, with ``fmt="json"``, one JSON object
    per line with bound fields flattened to top level (log aggregators;
    the ``--log-format json`` CLI flag). ``trace_id`` appears as an
    ordinary field in both formats when the telemetry interceptors bind it.
    """

    def __init__(
        self,
        output: TextIO | None = None,
        level: int = INFO,
        fields: tuple[tuple[str, Any], ...] = (),
        _lock: threading.Lock | None = None,
        fmt: str = "text",
    ):
        # None = resolve sys.stderr at write time: a captured-at-construction
        # stream may be replaced/closed later (pytest capsys, daemon redirects).
        self._output = output
        self.level = level
        self._fields = fields
        self._lock = _lock or threading.Lock()
        if fmt not in FORMATS:
            raise ValueError(f"unknown log format: {fmt!r}")
        self.fmt = fmt

    def with_fields(self, **fields: Any) -> "Logger":
        return Logger(
            self._output,
            self.level,
            self._fields + tuple(fields.items()),
            self._lock,
            self.fmt,
        )

    def log(self, level: int, msg: str, **fields: Any) -> None:
        if level < self.level:
            return
        all_fields = self._fields + tuple(fields.items())
        if self.fmt == "json":
            record: dict[str, Any] = {
                "ts": _timestamp(),
                "level": _LEVEL_NAMES.get(level, str(level)),
                "msg": msg,
            }
            # Flattened, last-wins on collisions; non-JSON values (lazy
            # payload formatters, protos) stringify via default=repr.
            record.update(all_fields)
            line = json.dumps(record, default=repr) + "\n"
        else:
            parts = [_timestamp(), _LEVEL_NAMES.get(level, str(level)), msg]
            if all_fields:
                parts.append(
                    "| " + " ".join(f"{k}: {v!r}" for k, v in all_fields))
            line = " ".join(parts) + "\n"
        with self._lock:
            out = self._output if self._output is not None else sys.stderr
            try:
                out.write(line)
            except ValueError:
                pass  # stream closed under us (interpreter/test teardown)

    def debug(self, msg: str, **fields: Any) -> None:
        self.log(DEBUG, msg, **fields)

    def info(self, msg: str, **fields: Any) -> None:
        self.log(INFO, msg, **fields)

    def warning(self, msg: str, **fields: Any) -> None:
        self.log(WARNING, msg, **fields)

    def error(self, msg: str, **fields: Any) -> None:
        self.log(ERROR, msg, **fields)


_global = Logger()
_ctx_logger: contextvars.ContextVar[Logger | None] = contextvars.ContextVar(
    "oim_logger", default=None
)


def set_global(logger: Logger) -> Logger:
    """Install the process-global fallback logger; returns the previous one."""
    global _global
    prev, _global = _global, logger
    return prev


def get_global() -> Logger:
    return _global


def from_context() -> Logger:
    """The logger attached to the current context, else the global one."""
    return _ctx_logger.get() or _global


@contextlib.contextmanager
def with_logger(logger: Logger) -> Iterator[Logger]:
    """Attach ``logger`` to the current context for the duration of the block."""
    token = _ctx_logger.set(logger)
    try:
        yield logger
    finally:
        _ctx_logger.reset(token)
