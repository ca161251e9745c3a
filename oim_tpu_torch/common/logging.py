"""A small structured logger: ``<time> <level> <msg> | k: v`` lines, or one
JSON object per line.

The port's own copy of the shape ``oim_tpu.common.logging`` gives its
callers (``from_context().info("step", loss=...)``), kept to what the
training loop needs: levels, text or JSON output.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, TextIO

DEBUG, INFO, WARNING, ERROR = 10, 20, 30, 40
_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARNING: "WARNING", ERROR: "ERROR"}
_NAME_LEVELS = {v.lower(): k for k, v in _LEVEL_NAMES.items()}


def parse_level(name: str) -> int:
    try:
        return _NAME_LEVELS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown log level: {name!r}") from None


def _timestamp() -> str:
    now = time.time()
    return (time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now))
            + ".%03d" % (int(now * 1000) % 1000))


class Logger:
    """A leveled logger writing one line per record."""

    def __init__(self, output: TextIO | None = None, level: int = INFO,
                 fmt: str = "text"):
        if fmt not in ("text", "json"):
            raise ValueError(f"unknown log format: {fmt!r}")
        # None = resolve sys.stderr at write time (it may be replaced later).
        self._output = output
        self.level = level
        self.fmt = fmt
        self._lock = threading.Lock()

    def log(self, level: int, msg: str, **fields: Any) -> None:
        if level < self.level:
            return
        name = _LEVEL_NAMES.get(level, str(level))
        if self.fmt == "json":
            record = {"ts": _timestamp(), "level": name, "msg": msg}
            record.update(fields)
            line = json.dumps(record, default=repr) + "\n"
        else:
            parts = [_timestamp(), name, msg]
            if fields:
                parts.append("| " + " ".join(f"{k}: {v!r}" for k, v in fields.items()))
            line = " ".join(parts) + "\n"
        with self._lock:
            out = self._output if self._output is not None else sys.stderr
            try:
                out.write(line)
            except ValueError:
                pass  # stream closed under us (interpreter teardown)

    def debug(self, msg: str, **fields: Any) -> None:
        self.log(DEBUG, msg, **fields)

    def info(self, msg: str, **fields: Any) -> None:
        self.log(INFO, msg, **fields)

    def warning(self, msg: str, **fields: Any) -> None:
        self.log(WARNING, msg, **fields)

    def error(self, msg: str, **fields: Any) -> None:
        self.log(ERROR, msg, **fields)


_global = Logger()


def set_global(logger: Logger) -> Logger:
    """Install the process-global logger; returns the previous one."""
    global _global
    prev, _global = _global, logger
    return prev


def from_context() -> Logger:
    """The process-global logger (the JAX package's ambient-context lookup
    reduced to what the port's single-threaded loop needs)."""
    return _global
