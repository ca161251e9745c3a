"""Tracing (``oim_tpu/common/tracing.py``): in-process span recording
with trace-context propagation, without the gRPC interceptors.

* ``start_span`` records spans into a bounded in-process ring buffer; the
  current span rides a contextvar so nested spans form a tree.
  ``record_phase`` records a phase measured after the fact (the serving
  engine's queue-wait and decode phases, known complete only at
  retirement).
* Trace context travels as ``oim-trace`` metadata in traceparent form
  (``00-<trace_id>-<span_id>-01``): ``inject`` and ``extract`` work on
  plain ``(key, value)`` tuples, so the RPC interceptors that carry it
  across hops can wrap them later.
* Spans export as Chrome trace-event JSON, which loads in Perfetto or
  ``chrome://tracing`` beside a ``torch.profiler`` trace and which the JAX
  package's ``load_trace_file`` and ``merge_trace_dir`` read unchanged.
  With a ``--trace-dir`` the recorder streams events as they finish
  (crash-safe: the JSON array is intentionally left unterminated, which
  Perfetto accepts), and the metrics server serves the ring buffer at
  ``GET /debug/spans``.
* The device trace: while a ``torch.profiler`` records, every live span
  is also a ``record_function`` range of its name, and ``device_range``
  marks a block that the ring should not hold (a layer of one step), so
  the kernels a block launches land under its name in the profiler's
  trace. With no profiler recording neither touches the profiler.
  ``load_trace_file`` moves a profiler export onto the spans' Unix clock,
  so ``merge_trace_dir`` lines the two up.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import secrets
import sys
import threading
import time
from typing import Any, Iterator, NamedTuple, Sequence

from oim_tpu_torch.common.redact import redact_text

# Request-metadata key carrying the trace context (traceparent-style).
TRACE_METADATA_KEY = "oim-trace"
_TRACEPARENT_VERSION = "00"
_REDACTED_FLAGS = "01"


class SpanContext(NamedTuple):
    """The propagated identity of a span: 128-bit trace, 64-bit span."""

    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars

    def to_metadata_value(self) -> str:
        return (f"{_TRACEPARENT_VERSION}-{self.trace_id}-"
                f"{self.span_id}-{_REDACTED_FLAGS}")

    @classmethod
    def from_metadata_value(cls, value: str) -> "SpanContext | None":
        parts = value.split("-")
        # Tolerate both the 4-field traceparent form and a bare
        # "<trace>-<span>" (hand-written test metadata).
        if len(parts) == 4:
            parts = parts[1:3]
        if len(parts) != 2:
            return None
        trace_id, span_id = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        return cls(trace_id, span_id)


class Span:
    """One recorded operation; finished spans are immutable records."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_unix",
                 "duration", "attrs", "tid", "_t0")

    def __init__(self, name: str, context: SpanContext, parent_id: str = "",
                 attrs: dict[str, Any] | None = None):
        self.name = name
        self.trace_id = context.trace_id
        self.span_id = context.span_id
        self.parent_id = parent_id
        self.start_unix = time.time()
        self.duration = 0.0
        self.attrs: dict[str, Any] = attrs or {}
        self.tid = threading.get_ident() % 1_000_000
        self._t0 = time.monotonic()

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def finish(self) -> None:
        self.duration = time.monotonic() - self._t0

    def to_event(self, pid: int) -> dict[str, Any]:
        """Chrome trace-event ("X" complete event, microsecond clock).
        String attribute values pass through the secret-redaction helper:
        endpoint strings and registry values recorded on spans must not
        leak credentials into trace files or /debug/spans."""
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            args["parent_id"] = self.parent_id
        for k, v in self.attrs.items():
            args[k] = (v if isinstance(v, (int, float, bool))
                       else redact_text(str(v)))
        return {
            "name": self.name,
            "cat": "oim",
            "ph": "X",
            "ts": self.start_unix * 1e6,
            "dur": self.duration * 1e6,
            "pid": pid,
            "tid": self.tid,
            "args": args,
        }


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


class SpanRecorder:
    """Bounded ring of finished spans + optional streaming file export.

    The file is Chrome trace-event JSON written incrementally: ``[`` then
    one event per finished span. The closing ``]`` is never written — the
    Perfetto/chrome://tracing parsers accept a truncated array, which makes
    the file valid even when the daemon is SIGKILLed mid-run (the same
    crash-only stance as the registry journal).

    Tail sampling bounds the FILE under serving load (the ring is bounded
    by construction): a span is exported when it errored (non-OK status
    code), ran slower than its per-name latency threshold, or survives a
    probabilistic keep — decided by a hash of its trace_id, so one kept
    trace exports ALL its spans and a dropped one exports none (a sampled
    trace file with holes in the middle of a request is worse than none).
    ``sample=1.0`` (the default) keeps everything — the pre-sampling
    behavior.
    """

    # Streamed events are flushed at most this often: flush-per-span would
    # gate every RPC handler thread on a write syscall; a bounded tail
    # (one interval) is all a SIGKILL can lose.
    FLUSH_INTERVAL = 0.2
    # Per-name latency threshold default: spans slower than this always
    # export regardless of the sampling probability ("tail" sampling —
    # the slow outliers are the spans worth keeping).
    SLOW_THRESHOLD_S = 0.1

    def __init__(self, service: str = "oim", trace_dir: str = "",
                 capacity: int = 4096, sample: float = 1.0,
                 slow_threshold_s: float | None = None,
                 slow_thresholds: dict[str, float] | None = None):
        self.service = service
        self.trace_dir = trace_dir
        # capacity == 0 disables ring recording entirely (the
        # observability-overhead bench's "off" configuration).
        self.capacity = max(0, capacity)
        self.sample = sample
        self.slow_threshold_s = (self.SLOW_THRESHOLD_S
                                 if slow_threshold_s is None
                                 else slow_threshold_s)
        # Span-name -> latency threshold overrides (e.g. a decode step is
        # "slow" at 50ms where a staging pass is slow at 10s).
        self.slow_thresholds = dict(slow_thresholds or {})
        self.pid = os.getpid()
        self._spans: list[Span] = []
        self._next = 0  # ring cursor
        self._lock = threading.Lock()
        # Separate lock for the streamed file: disk latency must not block
        # ring readers (/debug/spans) or other recorders on the ring lock.
        self._file_lock = threading.Lock()
        self._file = None
        self._last_flush = 0.0
        self._dropped = 0
        self._sampled_out = 0

    # -- tail-sampling policy ---------------------------------------------

    def keep_for_export(self, span: Span) -> bool:
        """The tail-sampling verdict for the streamed file. Always keep
        errors and slow spans; otherwise a deterministic trace_id-hash
        coin flip at ``sample`` probability (trace-coherent: every
        recorder in the fleet keeps or drops a trace's spans together,
        because they hash the same trace_id)."""
        if self.sample >= 1.0:
            return True
        code = span.attrs.get("code")
        if code not in (None, "", "OK"):
            return True
        threshold = self.slow_thresholds.get(
            span.name, self.slow_threshold_s)
        if threshold > 0 and span.duration >= threshold:
            return True
        if self.sample <= 0.0:
            return False
        try:
            bucket = int(span.trace_id[:8], 16) / 0xFFFFFFFF
        except ValueError:  # non-hex test ids: keep
            return True
        return bucket < self.sample

    # -- recording --------------------------------------------------------

    def record(self, span: Span) -> None:
        if self.capacity > 0:
            with self._lock:
                if len(self._spans) < self.capacity:
                    self._spans.append(span)
                else:
                    self._spans[self._next] = span
                    self._next = (self._next + 1) % self.capacity
                    self._dropped += 1
        if self.trace_dir:
            if not self.keep_for_export(span):
                self._sampled_out += 1
                return
            with self._file_lock:
                self._write_event(span.to_event(self.pid))

    def spans(self) -> list[Span]:
        """Ring snapshot, oldest first."""
        with self._lock:
            return self._spans[self._next:] + self._spans[:self._next]

    def to_events(self) -> list[dict[str, Any]]:
        events: list[dict[str, Any]] = [self._process_meta()]
        events.extend(s.to_event(self.pid) for s in self.spans())
        return events

    # -- export -----------------------------------------------------------

    def _process_meta(self) -> dict[str, Any]:
        return {"name": "process_name", "ph": "M", "pid": self.pid,
                "args": {"name": self.service}}

    def _write_event(self, event: dict[str, Any]) -> None:
        # Called under self._file_lock.
        if self._file is None:
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(
                self.trace_dir, f"{self.service}-{self.pid}.trace.json")
            self._file = open(path, "w")
            self._file.write("[\n")
            self._file.write(json.dumps(self._process_meta()))
        self._file.write(",\n" + json.dumps(event))
        now = time.monotonic()
        if now - self._last_flush >= self.FLUSH_INTERVAL:
            self._file.flush()
            self._last_flush = now

    def export(self, path: str) -> None:
        """Write the ring buffer as a complete Chrome trace JSON file."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_events()}, f)

    def flush(self) -> None:
        with self._file_lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        with self._file_lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_recorder = SpanRecorder()
_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "oim_span", default=None)


def configure(service: str, trace_dir: str = "",
              capacity: int = 4096, sample: float = 1.0,
              slow_threshold_s: float | None = None,
              slow_thresholds: dict[str, float] | None = None) -> SpanRecorder:
    """Install the process-global recorder (one per daemon; the service
    name becomes the Perfetto process label). ``capacity`` sizes the
    span ring (``--trace-ring``); ``sample``/``slow_threshold_s`` set
    the file-export tail-sampling policy (``--trace-sample`` /
    ``--trace-slow-ms``). Returns it."""
    global _recorder
    _recorder.close()
    _recorder = SpanRecorder(service, trace_dir, capacity, sample,
                             slow_threshold_s, slow_thresholds)
    return _recorder


def recorder() -> SpanRecorder:
    return _recorder


def current() -> Span | None:
    """The active span in this context, else None."""
    return _current.get()


def current_context() -> SpanContext | None:
    span = _current.get()
    return span.context if span is not None else None


def trace_id() -> str:
    """The active trace id (for log binding), or ""."""
    span = _current.get()
    return span.trace_id if span is not None else ""


_NO_RANGE = contextlib.nullcontext()


def device_range(name: str) -> contextlib.AbstractContextManager:
    """A ``torch.profiler`` range ``name`` around the block while a torch
    profiler records (its host ops and the kernels they launch fall under
    it in the profiler's trace), else a no-op that costs one flag read: a
    ``record_function`` entered with no profiler costs ~10 us. Records
    nothing in the span ring. Never imports torch: a process that has not
    loaded it has no profiler to mark."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return _NO_RANGE
    return torch.autograd.profiler.record_function(name)


@contextlib.contextmanager
def start_span(name: str, parent: SpanContext | None = None,
               **attrs: Any) -> Iterator[Span]:
    """Record ``name`` as a span around the block.

    Parent resolution: an explicit ``parent`` (e.g. extracted from request
    metadata) wins; otherwise the context's current span; otherwise a new
    trace is born here (root span). The block is also a ``device_range``
    of the same name.
    """
    if parent is None:
        parent = current_context()
    if parent is None:
        ctx = SpanContext(_new_trace_id(), _new_span_id())
        parent_id = ""
    else:
        ctx = SpanContext(parent.trace_id, _new_span_id())
        parent_id = parent.span_id
    span = Span(name, ctx, parent_id, attrs)
    token = _current.set(span)
    try:
        with device_range(name):
            yield span
    finally:
        _current.reset(token)
        span.finish()
        _recorder.record(span)


def record_phase(name: str, start_unix: float, duration: float,
                 parent: SpanContext | None = None, **attrs: Any) -> Span:
    """Record a span for a phase measured AFTER the fact — a block whose
    boundaries were timestamps, not a ``with`` scope (the serve engine's
    queue-wait and decode phases are bookkept per request and only known
    complete at retirement). The span lands in the ring and the export
    stream exactly like a live one; ``oimctl --autopsy`` attributes the
    request timeline from these."""
    if parent is None:
        parent = current_context()
    if parent is None:
        ctx = SpanContext(_new_trace_id(), _new_span_id())
        parent_id = ""
    else:
        ctx = SpanContext(parent.trace_id, _new_span_id())
        parent_id = parent.span_id
    span = Span(name, ctx, parent_id, attrs)
    span.start_unix = start_unix
    span.duration = max(duration, 0.0)
    _recorder.record(span)
    return span


# -- metadata propagation --------------------------------------------------


def inject(metadata: Sequence[tuple[str, Any]] | None,
           context: SpanContext | None = None) -> list[tuple[str, Any]]:
    """Return ``metadata`` with ``context`` (default: the current span's)
    as the ``oim-trace`` entry, replacing any stale one — a proxied call
    must carry the hop's own span, not the original caller's. With no
    context to inject the metadata passes through untouched, so an
    explicitly injected entry survives a no-op re-injection."""
    md = list(metadata or ())
    ctx = context if context is not None else current_context()
    if ctx is None:
        return md
    md = [(k, v) for k, v in md if k != TRACE_METADATA_KEY]
    md.append((TRACE_METADATA_KEY, ctx.to_metadata_value()))
    return md


def extract(metadata: Sequence[tuple[str, Any]] | None) -> SpanContext | None:
    for key, value in metadata or ():
        if key == TRACE_METADATA_KEY and isinstance(value, str):
            return SpanContext.from_metadata_value(value)
    return None


# -- trace file merging (make trace-demo / offline analysis) ---------------


def load_trace_file(path: str) -> list[dict[str, Any]]:
    """Parse one streamed trace file, tolerating what a killed daemon
    leaves behind: an unterminated array (the by-design steady state),
    AND a final record truncated mid-write (SIGKILL between the write
    syscalls of one event). The writer emits one event per line, so a
    torn tail is recovered by dropping trailing lines until the array
    parses — the same torn-tail stance as the registry journal replay.
    A ``torch.profiler`` export (``{"traceEvents": ..., "baseTimeNanoseconds":
    ...}``) stamps its events relative to that base: they are shifted onto
    the spans' Unix-microsecond clock."""
    text = open(path).read().strip()
    if not text:
        return []

    def parse(candidate: str):
        if candidate.startswith("[") and not candidate.endswith("]"):
            candidate = candidate.rstrip().rstrip(",") + "]"
        events = json.loads(candidate)
        if isinstance(events, dict):  # a complete {"traceEvents": ...} export
            base = events.get("baseTimeNanoseconds")
            events = events.get("traceEvents", [])
            if base:
                shift = base / 1e3
                for ev in events:
                    if "ts" in ev:
                        ev["ts"] = float(ev["ts"]) + shift
        return events

    try:
        return parse(text)
    except json.JSONDecodeError:
        pass
    lines = text.splitlines()
    while lines:
        lines.pop()
        if not lines:
            break
        try:
            return parse("\n".join(lines))
        except json.JSONDecodeError:
            continue
    return []


def merge_trace_dir(trace_dir: str, out_path: str = "") -> list[dict[str, Any]]:
    """Merge every ``*.trace.json`` under ``trace_dir`` into one event
    list (optionally written as a complete Chrome trace at ``out_path``) —
    wall-clock timestamps align processes on one Perfetto timeline, and a
    ``profile_trace`` export there joins them on the same clock."""
    events: list[dict[str, Any]] = []
    for name in sorted(os.listdir(trace_dir)):
        if name.endswith(".trace.json"):
            events.extend(load_trace_file(os.path.join(trace_dir, name)))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"traceEvents": events}, f)
    return events
