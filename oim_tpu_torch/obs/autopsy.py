"""Per-request latency autopsy: one trace_id -> one phase-attributed
timeline across the fleet.

Metrics say a p99 bucket is slow; spans say how long each hop took;
neither answers "where did THIS request's 600ms go" without hand-walking
``/debug/spans`` on every daemon. The autopsy automates the walk:

1. discover the fleet's debug endpoints from the TTL-leased
   ``telemetry/<id>`` rows (the caller passes the targets — oimctl
   resolves them from the registry);
2. fetch every daemon's ``/debug/spans`` (Chrome trace JSON) and
   ``/debug/events?trace=<id>``, keeping only the trace's records;
3. attribute the routed request's wall clock (the root
   ``router.generate`` span, else ``serve.generate``) to named phases —
   router pick, retry dials, transport, admission queue wait, prefill
   (prefix hit/miss + tokens saved), decode cadence — and call out the
   unattributed remainder explicitly: a gap nobody can explain is a
   finding, not a rounding error.

Phases come from real spans where they exist (``serve.prefill``) and
from the synthesized phase spans the engine records at request
retirement (``serve.queue_wait``, ``serve.decode`` —
tracing.record_phase), so attribution needs no new RPC and works on a
post-mortem span dump exactly like on a live fleet. Cross-process
timestamps are wall-clock (the same alignment the trace-merge tooling
relies on); small skews surface as overlap, which the union-based
coverage accounting tolerates.
"""

from __future__ import annotations

import json
from typing import Callable, Iterable

ROUTER_ROOT = "router.generate"
SERVE_ROOT = "serve.generate"
CLIENT_HOP = "client:oim.v1.Serve/Generate"
SERVER_HOP = "server:oim.v1.Serve/Generate"


def _http_get(url: str, timeout: float = 10.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def collect(trace_id: str, targets: Iterable[str],
            http_get: Callable[[str], str] = _http_get) -> dict:
    """Fan out to each ``host:port`` target's /debug endpoints and keep
    the trace's spans + events. Targets are deduplicated; an unreachable
    daemon is recorded in ``unreachable`` and skipped — a dead replica
    must not block the autopsy of a request it may have caused."""
    spans: list[dict] = []
    events: list[dict] = []
    unreachable: list[str] = []
    seen_span_ids: set[str] = set()
    seen_events: set[tuple] = set()
    for target in sorted(set(t for t in targets if t)):
        try:
            span_doc = json.loads(http_get(f"http://{target}/debug/spans"))
            event_doc = json.loads(
                http_get(f"http://{target}/debug/events?trace={trace_id}"))
        except Exception:  # noqa: BLE001 - per-target resilience
            unreachable.append(target)
            continue
        for ev in span_doc.get("traceEvents", []):
            args = ev.get("args") or {}
            if ev.get("ph") != "X" or args.get("trace_id") != trace_id:
                continue
            sid = args.get("span_id", "")
            if sid and sid in seen_span_ids:
                continue  # two telemetry rows advertising one process
            seen_span_ids.add(sid)
            spans.append(ev)
        for ev in event_doc.get("events", []):
            key = (ev.get("ts"), ev.get("type"), ev.get("seq"))
            if key in seen_events:
                continue
            seen_events.add(key)
            events.append(ev)
    spans.sort(key=lambda s: s.get("ts", 0.0))
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"trace_id": trace_id, "spans": spans, "events": events,
            "unreachable": unreachable}


def _interval(span: dict) -> tuple[float, float]:
    """(start, end) seconds (Chrome events carry microseconds)."""
    start = span.get("ts", 0.0) / 1e6
    return start, start + span.get("dur", 0.0) / 1e6


def _union_seconds(intervals: list[tuple[float, float]],
                   lo: float, hi: float) -> float:
    """Total length of the union of intervals clipped to [lo, hi]."""
    clipped = sorted(
        (max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    covered = 0.0
    cursor = lo
    for a, b in clipped:
        a = max(a, cursor)
        if b > a:
            covered += b - a
            cursor = b
    return covered


def _phase(name: str, start: float, end: float, t0: float,
           detail: str = "") -> dict | None:
    if end - start <= 0:
        return None
    return {"name": name, "start_ms": (start - t0) * 1e3,
            "dur_ms": (end - start) * 1e3, "detail": detail}


def analyze(collected: dict) -> dict:
    """Attribute the trace's wall time to named phases.

    Raises ValueError when no root span exists for the trace (nothing
    recorded it — wrong id, or every ring already evicted it)."""
    spans = collected["spans"]
    by_name: dict[str, list[dict]] = {}
    for s in spans:
        by_name.setdefault(s.get("name", ""), []).append(s)
    root = (by_name.get(ROUTER_ROOT) or by_name.get(SERVE_ROOT) or [None])[0]
    if root is None:
        raise ValueError(
            f"no {ROUTER_ROOT}/{SERVE_ROOT} span for trace "
            f"{collected['trace_id']!r} on any reachable daemon")
    t0, t1 = _interval(root)
    wall = t1 - t0
    phases: list[dict] = []

    def attrs(span: dict) -> dict:
        return span.get("args") or {}

    # Only the router's OWN dials count as hops: the caller's client
    # span (bench/oimctl dialing the router) shares the name and the
    # trace but PARENTS the root — classifying it as a retry would
    # attribute the whole request to a phantom failed dial.
    root_sid = attrs(root).get("span_id", "")
    clients = sorted(
        (s for s in by_name.get(CLIENT_HOP, [])
         if attrs(s).get("parent_id") == root_sid),
        key=lambda s: s["ts"])
    winner = clients[-1] if clients else None

    def child_of(candidates, parent_sid):
        if not parent_sid:
            return None
        return next((s for s in candidates
                     if attrs(s).get("parent_id") == parent_sid), None)

    # THE serve span is the winner's, resolved through the parent chain
    # (winner client hop -> its server hop -> serve.generate): a retry
    # that was admitted on a failed replica leaves an earlier
    # serve.generate span on the trace, and first-by-ts would attribute
    # transport/queue/prefill from the aborted attempt. Chain-less
    # recordings (older daemons) fall back to the LAST serve span.
    serves = by_name.get(SERVE_ROOT, [])
    serve = None
    if winner is not None:
        server_hop = child_of(by_name.get(SERVER_HOP, []),
                              attrs(winner).get("span_id"))
        if server_hop is not None:
            serve = child_of(serves, attrs(server_hop).get("span_id"))
    if serve is None and serves:
        serve = serves[-1]
    serve_sid = attrs(serve).get("span_id", "") if serve is not None \
        else ""

    def serve_children(name: str) -> list[dict]:
        """The chosen serve attempt's phase spans: scoped by parent
        when the chain exists, every span of the name otherwise."""
        spans_ = by_name.get(name, [])
        if serve_sid:
            scoped = [s for s in spans_
                      if attrs(s).get("parent_id") == serve_sid]
            if scoped or len(serves) > 1:
                return scoped
        return spans_

    if root.get("name") == ROUTER_ROOT and clients:
        # Everything before the first dial is the router's pick.
        first_start = _interval(clients[0])[0]
        phases.append(_phase("router pick", t0, first_start, t0))
        for hop in clients[:-1]:
            a, b = _interval(hop)
            phases.append(_phase(
                "router retry dial", a, b, t0,
                detail=f"code={attrs(hop).get('code', '?')}"))
        wa, wb = _interval(winner)
        if serve is not None:
            sa, sb = _interval(serve)
            phases.append(_phase("transport send", wa, sa, t0))
            phases.append(_phase("stream close", sb, wb, t0))
        phases.append(_phase("router return", wb, t1, t0))
    if serve is not None:
        for span in serve_children("serve.queue_wait"):
            a, b = _interval(span)
            phases.append(_phase("admission queue", a, b, t0))
        for span in serve_children("serve.prefill"):
            a, b = _interval(span)
            sp_attrs = attrs(span)
            prefix = int(sp_attrs.get("prefix_tokens", 0) or 0)
            tokens = sp_attrs.get("prompt_tokens", "?")
            hit = (f"prefix HIT, {prefix} tokens saved" if prefix
                   else "prefix miss")
            phases.append(_phase(
                "prefill", a, b, t0,
                detail=f"{tokens} prompt tokens, {hit}"))
        for span in serve_children("serve.draft_prefill"):
            a, b = _interval(span)
            phases.append(_phase("draft prefill", a, b, t0))
        for span in serve_children("serve.decode"):
            a, b = _interval(span)
            sp_attrs = attrs(span)
            tokens = int(sp_attrs.get("tokens", 0) or 0)
            cadence = ((b - a) * 1e3 / tokens) if tokens else 0.0
            detail = f"{tokens} tokens, {cadence:.1f}ms/token"
            accept = sp_attrs.get("spec_accept")
            if accept is not None:
                detail += f", spec accept {float(accept):.0%}"
            phases.append(_phase("decode", a, b, t0, detail=detail))
    phases = [p for p in phases if p is not None]
    phases.sort(key=lambda p: p["start_ms"])
    intervals = [(t0 + p["start_ms"] / 1e3,
                  t0 + (p["start_ms"] + p["dur_ms"]) / 1e3) for p in phases]
    covered = _union_seconds(intervals, t0, t1)
    coverage = covered / wall if wall > 0 else 0.0
    return {
        "trace_id": collected["trace_id"],
        "root": root.get("name"),
        "wall_ms": wall * 1e3,
        "t0_unix": t0,
        "phases": phases,
        "coverage": coverage,
        "unattributed_ms": max(wall - covered, 0.0) * 1e3,
        "events": [
            {"ts": e.get("ts", 0.0), "type": e.get("type", "?"),
             "attrs": e.get("attrs") or {}}
            for e in collected["events"]
        ],
        "unreachable": collected.get("unreachable", []),
    }


def render(report: dict) -> str:
    """The terminal timeline: one line per phase, offsets from the root
    span's start, the unattributed gap called out last."""
    lines = [
        f"autopsy {report['trace_id']}  root={report['root']}  "
        f"wall={report['wall_ms']:.1f}ms  "
        f"attributed={report['coverage']:.1%}"
    ]
    for p in report["phases"]:
        detail = f"  [{p['detail']}]" if p["detail"] else ""
        lines.append(
            f"  {p['start_ms']:8.1f}ms  +{p['dur_ms']:8.1f}ms  "
            f"{p['name']:<18}{detail}")
    lines.append(
        f"  unattributed gap: {report['unattributed_ms']:.1f}ms "
        f"({1 - report['coverage']:.1%})")
    if report["events"]:
        lines.append("events on this trace:")
        for e in report["events"]:
            attrs = " ".join(f"{k}={v}" for k, v in sorted(e["attrs"].items()))
            lines.append(f"  {e['ts']:.3f}  {e['type']}  {attrs}")
    if report["unreachable"]:
        lines.append(
            f"unreachable daemons (spans may be incomplete): "
            f"{', '.join(report['unreachable'])}")
    return "\n".join(lines)


def autopsy(trace_id: str, targets: Iterable[str],
            http_get: Callable[[str], str] = _http_get) -> dict:
    """collect + analyze in one call (the oimctl --autopsy entry)."""
    return analyze(collect(trace_id, targets, http_get))
