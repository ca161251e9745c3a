"""oimctl admin CLI: get/set registry keys + cluster health view over mTLS
(reference cmd/oimctl/main.go). ``--registry`` accepts a comma-separated
endpoint list (replicated pair): commands fail over to the next endpoint
on UNAVAILABLE / FAILED_PRECONDITION; ``--promote`` promotes the standby."""

from __future__ import annotations

import argparse
from typing import TYPE_CHECKING

from oim_tpu_torch.cli.common import (
    add_common_flags,
    add_registry_flag,
    load_tls_flags,
    setup_logging,
)
from oim_tpu_torch.common.pathutil import REGISTRY_ADDRESS, REGISTRY_MESH

# grpc, the stubs and the channel pool load where the registry is dialed:
# --metrics, --events and the scrape-side helpers run without grpcio.
if TYPE_CHECKING:
    from oim_tpu_torch.spec.services import RegistryStub


def health_rows(stub: RegistryStub) -> list[tuple[str, str, str, str]]:
    """(controller, status, address, mesh) per registered controller.

    Status is derived from the lease plane: ALIVE when the address key
    survives the registry's lease filter, STALE when it only shows up in
    the ``include_stale`` view (lease expired — the controller stopped
    heartbeating; the proxy fast-fails it and feeders fail away from it).
    """
    from oim_tpu_torch.spec import oim_pb2 as pb

    live = {
        v.path
        for v in stub.GetValues(pb.GetValuesRequest(path=""), timeout=10).values
    }
    stale = stub.GetValues(
        pb.GetValuesRequest(path="", include_stale=True), timeout=10
    ).values
    entries = {v.path: v.value for v in stale}
    rows = []
    for path in sorted(entries):
        cid, _, key = path.partition("/")
        if key != REGISTRY_ADDRESS:
            continue
        status = "ALIVE" if path in live else "STALE"
        mesh = entries.get(f"{cid}/{REGISTRY_MESH}", "")
        rows.append((cid, status, entries[path], mesh))
    return rows


def serve_health_rows(stub: RegistryStub) -> list[tuple[str, str, str, str]]:
    """One row per registered serving replica (`oim-serve --serve-id`),
    from the TTL-leased ``serve/<id>`` load snapshots: lease freshness
    (ALIVE/STALE, same lease-plane semantics as the controller rows),
    routed endpoint, and the advertised load (free decode slots, queued
    requests, readiness — a draining replica shows ready=false for its
    last beats before deregistering)."""
    import json

    from oim_tpu_torch.common.pathutil import REGISTRY_SERVE
    from oim_tpu_torch.spec import oim_pb2 as pb

    live = {
        v.path
        for v in stub.GetValues(
            pb.GetValuesRequest(path=REGISTRY_SERVE), timeout=10).values
    }
    stale = stub.GetValues(
        pb.GetValuesRequest(path=REGISTRY_SERVE, include_stale=True),
        timeout=10,
    ).values
    rows = []
    for value in sorted(stale, key=lambda v: v.path):
        try:
            snap = json.loads(value.value)
        except ValueError:
            snap = {}
        if not isinstance(snap, dict):
            snap = {}
        status = "ALIVE" if value.path in live else "STALE"
        if "member" in snap:
            # A sharded replica's member lease (serve/<id>.member.<k>):
            # a liveness beacon, not a routing target — no endpoint, no
            # load snapshot. STALE here is exactly the signal that
            # flips the owning replica not-ready.
            load = (f"member={snap.get('member', '?')}/"
                    f"{snap.get('shard', '?')} "
                    f"state={snap.get('state', '?')}")
            rows.append((value.path, status, "-", load))
            continue
        load = (f"free={snap.get('free_slots', '?')}/"
                f"{snap.get('max_batch', '?')} "
                f"queue={snap.get('queue_depth', '?')} "
                f"ready={str(bool(snap.get('ready', False))).lower()}")
        rows.append((value.path, status, snap.get("endpoint", "?"), load))
    return rows


def registry_health_row(stub: RegistryStub) -> tuple[str, str, str, str] | None:
    """The registry's own row for the --health table, from the virtual
    ``registry/...`` status keys: role, replication lag (records/seconds),
    journal size. None for an unreplicated registry."""
    from oim_tpu_torch.spec import oim_pb2 as pb

    entries = {
        v.path: v.value
        for v in stub.GetValues(
            pb.GetValuesRequest(path="registry"), timeout=10).values
    }
    role = entries.get("registry/role")
    if role is None:
        return None
    detail = (
        f"epoch={entries.get('registry/epoch', '?')} "
        f"lag={entries.get('registry/replication/lag_records', '?')}rec/"
        f"{entries.get('registry/replication/lag_seconds', '?')}s "
        f"journal={entries.get('registry/replication/journal_bytes', '?')}B"
    )
    return ("_registry", role, detail, entries.get("registry/peer", ""))


def parse_prometheus_text(text: str):
    """Prometheus text format -> (types, helps, samples) where samples is
    [(name, {label: value}, float)]. Tolerant of anything a daemon's
    /metrics serves; label values may contain escaped quotes/newlines."""
    import re

    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    samples: list[tuple[str, dict[str, str], float]] = []
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("# HELP "):
            _, _, name, help_ = (line.split(None, 3) + [""])[:4]
            helps[name] = help_
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m and " # " in line:
            # OpenMetrics exemplar suffix on a histogram bucket
            # (`... 12 # {trace_id="..."} 0.04 171234.5`): the sample
            # value is everything before the marker. Exemplars are read
            # by parse_exemplars; this parser keeps the sample.
            m = sample_re.match(line.split(" # ", 1)[0].rstrip())
        if not m:
            raise ValueError(f"unparseable metrics line: {line!r}")
        # One left-to-right pass: chained str.replace would mis-decode a
        # literal backslash followed by 'n' (\\n -> backslash+n, not \n).
        unescape = {"n": "\n", '"': '"', "\\": "\\"}
        labels = {
            k: re.sub(r"\\(.)",
                      lambda esc: unescape.get(esc.group(1), esc.group(0)), v)
            for k, v in label_re.findall(m.group(3) or "")
        }
        samples.append((m.group(1), labels, float(m.group(4))))
    return types, helps, samples


def parse_exemplars(text: str) -> list[tuple[str, str]]:
    """(metric name, trace_id) per OpenMetrics exemplar in a scrape —
    the anchors that turn a latency bucket into a concrete request
    (feed the trace_id to --events / /debug/spans)."""
    import re

    out: list[tuple[str, str]] = []
    line_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{.*?\})?\s+\S+'
        r' # \{trace_id="((?:[^"\\]|\\.)*)"\}')
    for line in text.splitlines():
        m = line_re.match(line.strip())
        if m:
            out.append((m.group(1), m.group(2)))
    return out


def _histogram_quantile(buckets: list[tuple[float, float]], q: float) -> float:
    """Linear interpolation over cumulative le-buckets (the PromQL
    histogram_quantile estimate) — the shared obs/merge.py math, so the
    scrape summaries here and the fleet merge can never disagree."""
    from oim_tpu_torch.obs.merge import bucket_quantile

    return bucket_quantile(buckets, q)


def print_metrics(target: str) -> None:
    """GET /metrics on ``host:port`` and pretty-print: families grouped
    with their type + help, histograms summarized as count/mean/quantile
    estimates (the quick-scrape view; raw text is one curl away)."""
    import urllib.error
    import urllib.request

    try:
        # Ask for OpenMetrics: the server then includes the trace_id
        # exemplars (legal only in that format; the parser below strips
        # them from sample values, parse_exemplars reads them).
        request = urllib.request.Request(
            f"http://{target}/metrics",
            headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(request, timeout=10) as r:
            text = r.read().decode()
    except (urllib.error.URLError, OSError) as err:
        raise SystemExit(f"--metrics: cannot scrape http://{target}/metrics: "
                         f"{getattr(err, 'reason', err)}") from err
    types, helps, samples = parse_prometheus_text(text)
    by_family: dict[str, list[tuple[dict[str, str], float]]] = {}
    for name, labels, value in samples:
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        by_family.setdefault(base, []).append((name, labels, value))
    for family in sorted(by_family):
        kind = types.get(family, "untyped")
        help_ = helps.get(family, "")
        print(f"{family} [{kind}]" + (f" — {help_}" if help_ else ""))
        rows = by_family[family]
        if kind == "histogram":
            # Group by the non-le label set.
            series: dict[tuple, dict] = {}
            for name, labels, value in rows:
                key = tuple(sorted(
                    (k, v) for k, v in labels.items() if k != "le"))
                s = series.setdefault(
                    key, {"buckets": [], "sum": 0.0, "count": 0.0})
                if name.endswith("_bucket"):
                    s["buckets"].append((float(labels["le"]), value))
                elif name.endswith("_sum"):
                    s["sum"] = value
                elif name.endswith("_count"):
                    s["count"] = value
            for key, s in sorted(series.items()):
                label_str = ",".join(f'{k}="{v}"' for k, v in key)
                buckets = sorted(s["buckets"])
                mean = s["sum"] / s["count"] if s["count"] else float("nan")
                p50 = _histogram_quantile(buckets, 0.5)
                p99 = _histogram_quantile(buckets, 0.99)
                print(f"  {{{label_str}}} count={s['count']:g} "
                      f"mean={mean:.6g}s p50~{p50:.6g}s p99~{p99:.6g}s")
        else:
            for name, labels, value in sorted(
                    rows, key=lambda r: sorted(r[1].items())):
                label_str = ",".join(
                    f'{k}="{v}"' for k, v in sorted(labels.items()))
                prefix = f"  {{{label_str}}}" if label_str else " "
                print(f"{prefix} {value:g}")


def _http_get(url: str, timeout: float = 10.0) -> str:
    import urllib.error
    import urllib.request

    try:
        # OpenMetrics Accept: /metrics then carries exemplars (legal
        # only in that format); /debug/* endpoints ignore the header.
        request = urllib.request.Request(
            url, headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(request, timeout=timeout) as r:
            return r.read().decode()
    except (urllib.error.URLError, OSError) as err:
        raise SystemExit(
            f"cannot fetch {url}: {getattr(err, 'reason', err)}") from err


def fetch_events(target: str, trace: str = "", type_: str = "",
                 limit: int = 0) -> dict:
    """GET /debug/events on ``host:port`` -> the flight-recorder reply
    ({"events": [...], "dropped": n})."""
    import json
    import urllib.parse

    params = {}
    if trace:
        params["trace"] = trace
    if type_:
        params["type"] = type_
    if limit:
        params["limit"] = str(limit)
    query = f"?{urllib.parse.urlencode(params)}" if params else ""
    return json.loads(_http_get(f"http://{target}/debug/events{query}"))


def print_events(target: str, trace: str = "", type_: str = "") -> None:
    """Render a daemon's flight recorder: one line per event, oldest
    first — timestamp, type, trace_id, attributes."""
    import datetime

    doc = fetch_events(target, trace=trace, type_=type_)
    events = doc.get("events", [])
    if not events:
        scope = f" for trace {trace}" if trace else ""
        print(f"no recorded events{scope} "
              f"({doc.get('dropped', 0)} dropped from the ring)")
        return
    for event in events:
        ts = datetime.datetime.fromtimestamp(
            event.get("ts", 0)).strftime("%H:%M:%S.%f")[:-3]
        attrs = " ".join(
            f"{k}={v}" for k, v in sorted(
                (event.get("attrs") or {}).items()))
        tid = event.get("trace_id", "") or "-"
        print(f"{ts}\t{event.get('type', '?')}\t{tid}\t{attrs}")


# -- oimctl --top: the live cluster table -----------------------------------


def telemetry_rows(stub) -> list[tuple[str, str, str, str, dict]]:
    """(id, ALIVE|STALE, role, metrics endpoint, row body) per
    ``telemetry/<id>`` registry row — the self-published discovery rows
    every daemon's observability plane maintains (common/telemetry.py).
    The row body carries the fleet-mergeable ``hist``/``counters``
    payload the --top ALL row folds (empty dict for pre-upgrade
    daemons, which dash-degrade)."""
    import json

    from oim_tpu_torch.common.pathutil import REGISTRY_TELEMETRY
    from oim_tpu_torch.spec import oim_pb2 as pb

    live = {
        v.path
        for v in stub.GetValues(
            pb.GetValuesRequest(path=REGISTRY_TELEMETRY), timeout=10).values
    }
    stale = stub.GetValues(
        pb.GetValuesRequest(path=REGISTRY_TELEMETRY, include_stale=True),
        timeout=10,
    ).values
    rows = []
    for value in sorted(stale, key=lambda v: v.path):
        try:
            snap = json.loads(value.value)
        except ValueError:
            snap = {}
        if not isinstance(snap, dict):
            snap = {}
        rows.append((
            value.path.partition("/")[2],
            "ALIVE" if value.path in live else "STALE",
            str(snap.get("role", "?")),
            str(snap.get("metrics", "")),
            snap,
        ))
    return rows


def _series_value(samples, name: str, labels: dict | None = None):
    for n, lbls, v in samples:
        if n == name and (labels is None
                          or all(lbls.get(k) == want
                                 for k, want in labels.items())):
            return v
    return None


def _series_quantiles(samples, name: str, labels: dict,
                      qs=(0.5, 0.99)) -> list[float]:
    buckets = sorted(
        (float(lbls["le"]), v)
        for n, lbls, v in samples
        if n == f"{name}_bucket" and "le" in lbls
        and all(lbls.get(k) == want for k, want in labels.items())
    )
    return [_histogram_quantile(buckets, q) for q in qs]


def top_row(row_id: str, status: str, role: str, target: str,
            snap: dict | None = None, http_get=_http_get,
            parse_cache: dict | None = None) -> dict:
    """One `--top` table row: scrape ``target``'s /metrics +
    /debug/events and distill the columns. STALE/unreachable rows
    degrade to placeholders — a dead daemon must still show up (that it
    is dead IS the signal), not break the table. ``parse_cache`` (a
    --watch session's dict, target -> (scrape text, parsed samples))
    skips re-parsing a scrape whose text is byte-identical to the last
    refresh's — an idle daemon's scrape does not change between beats,
    and at hundreds of rows the parse dominates the fetch."""
    import json

    row = {"id": row_id, "status": status, "role": role, "qps": None,
           "tier": None,
           "ft_ms": (None, None), "it_ms": (None, None), "queue": None,
           "slots": None, "cache_hit": None, "prefix_hit": None,
           "pages": None, "kvtier": None, "accept": None, "shard": None,
           "repl_lag": None, "commit_ms": (None, None),
           "pick_ms": (None, None), "spread": None, "events": {}}
    if status != "ALIVE" or not target:
        return row
    try:
        text = http_get(f"http://{target}/metrics")
        cached = (parse_cache or {}).get(target)
        if cached is not None and cached[0] == text:
            samples = cached[1]
        else:
            _, _, samples = parse_prometheus_text(text)
            if parse_cache is not None:
                parse_cache[target] = (text, samples)
        events_doc = json.loads(
            http_get(f"http://{target}/debug/events?limit=512"))
    except (SystemExit, ValueError):
        row["status"] = "UNSCRAPEABLE"
        return row
    # Columns gate on role: every process declares every canonical
    # metric (common/metrics.py DEFAULT), so a registry's scrape carries
    # an oim_serve_qps of 0 — "-" for a column the role cannot have is
    # signal, 0 would be a lie.
    if role == "serve":
        row["qps"] = _series_value(samples, "oim_serve_qps")
        # Disaggregation role (prefill/decode/mixed): the info gauge's
        # label whose sample is 1. Dash for pre-role scrapes, whose
        # series is absent entirely — the PAGES/SHARD stance.
        for n, lbls, v in samples:
            if n == "oim_serve_role" and v == 1 and lbls.get("role"):
                row["tier"] = lbls["role"]
                break
        for key, kind in (("ft_ms", "first"), ("it_ms", "next")):
            p50, p99 = _series_quantiles(
                samples, "oim_serve_token_latency_seconds", {"kind": kind})
            if p50 == p50 or p99 == p99:  # at least one non-NaN
                row[key] = (p50 * 1e3, p99 * 1e3)
        row["queue"] = _series_value(samples, "oim_serve_queue_depth")
        row["slots"] = _series_value(
            samples, "oim_serve_slot_occupancy")
        # Prompt-prefix KV cache hit rate; "-" until the replica has
        # admitted anything — and for pre-prefix-cache replicas, whose
        # scrapes simply lack the series (UNSCRAPEABLE-safe like every
        # other column).
        phits = _series_value(samples, "oim_serve_prefix_hits_total")
        pmiss = _series_value(samples, "oim_serve_prefix_misses_total")
        if phits is not None and pmiss is not None and phits + pmiss > 0:
            row["prefix_hit"] = phits / (phits + pmiss)
        # Paged KV pool occupancy (used/total). Dash for pre-paged
        # replicas, whose scrapes lack the series entirely — the same
        # mixed-version stance as PREFIX-HIT.
        ptotal = _series_value(samples, "oim_serve_kv_pages_total")
        pused = _series_value(samples, "oim_serve_kv_pages_used")
        if ptotal is not None and pused is not None and ptotal > 0:
            row["pages"] = (pused, ptotal)
        # KV tiering census: hbm/host resident prefix pages plus the
        # lifetime peer-fetch attempt count. Dash for pre-tier replicas
        # (series absent from the scrape) — the PAGES stance again.
        hbm = _series_value(samples, "oim_kvtier_hbm_pages")
        host = _series_value(samples, "oim_kvtier_host_pages")
        if hbm is not None and host is not None:
            peer = sum(
                v for n, lbls, v in samples
                if n == "oim_serve_prefix_peer_fetches_total")
            row["kvtier"] = (hbm, host, peer)
        # Speculative-decoding acceptance: the valve's ROLLING window
        # when the scrape carries it (what fallback decisions track),
        # else the lifetime accepted/proposed ratio. Dash for pre-spec
        # scrapes (series absent) and for replicas that never
        # speculated — the PAGES/PREFIX-HIT mixed-version stance.
        sprop = _series_value(
            samples, "oim_serve_spec_proposed_tokens_total")
        sacc = _series_value(
            samples, "oim_serve_spec_accepted_tokens_total")
        if sprop is not None and sacc is not None and sprop > 0:
            rolling = _series_value(
                samples, "oim_serve_spec_accept_rolling")
            # `is not None`, not truthiness: a rolling rate of exactly
            # 0.0 (total collapse) is the one value this column most
            # needs to show instead of the healthy lifetime ratio.
            row["accept"] = rolling if rolling is not None \
                else sacc / sprop
        # Tensor-parallel member census: ready/total where total folds
        # in stale (lease-lapsed) members — "1/2" IS the degraded-but-
        # routed-away signal the rung pins. Dash for solo replicas
        # (both gauges 0: the engine never armed a member watch) and
        # for pre-shard scrapes lacking the series entirely — the
        # PAGES/KV-TIER mixed-version stance.
        sready = _series_value(
            samples, "oim_serve_shard_members", {"state": "ready"})
        sstale = _series_value(
            samples, "oim_serve_shard_members", {"state": "stale"})
        if sready is not None and sstale is not None \
                and sready + sstale > 0:
            row["shard"] = (sready, sready + sstale)
    hits = _series_value(samples, "oim_stage_cache_hits_total")
    misses = _series_value(samples, "oim_stage_cache_misses_total")
    if hits is not None and misses is not None and hits + misses > 0:
        row["cache_hit"] = hits / (hits + misses)
    if role == "registry":
        row["repl_lag"] = _series_value(
            samples, "oim_replication_lag_records")
        # Commit pipeline latency (quorum mode): append -> majority ack
        # -> applied. Dash for pair-mode/standalone registries, whose
        # histogram has no observations.
        p50, p99 = _series_quantiles(
            samples, "oim_registry_commit_seconds", {"phase": "total"})
        if p50 == p50 or p99 == p99:
            row["commit_ms"] = (p50 * 1e3, p99 * 1e3)
    if role == "router":
        # Per-request pick cost: the table-scan control-plane tax the
        # 10/100/1000-row curve pins (bench.py --control-plane).
        p50, p99 = _series_quantiles(
            samples, "oim_router_pick_seconds", {})
        if p50 == p50 or p99 == p99:
            row["pick_ms"] = (p50 * 1e3, p99 * 1e3)
        replicas = {
            lbls["replica"]
            for n, lbls, v in samples
            if n == "oim_router_requests_total" and lbls.get("replica")
            and v > 0
        }
        if replicas:
            row["spread"] = len(replicas)
    counts: dict[str, int] = {}
    for event in events_doc.get("events", []):
        t = event.get("type", "?")
        counts[t] = counts.get(t, 0) + 1
    row["events"] = counts
    return row


def fleet_top_row(entries) -> dict:
    """The synthesized ALL row: merged fleet percentiles folded from the
    histogram snapshots riding the telemetry rows themselves — no scrape
    fan-out, and a registry read (or Watch view) is the only input.
    Pre-upgrade daemons publish no snapshot and simply don't contribute;
    with none contributing every fleet column dashes (the mixed-version
    stance). ``entries`` are telemetry_rows()/TelemetryWatch.rows()
    5-tuples."""
    from oim_tpu_torch.obs import merge

    row = _empty_fleet_row()
    snapshots: dict[str, list] = {"first_token": [], "inter_token": []}
    contributors = 0
    for entry in entries:
        snap = entry[4] if len(entry) > 4 else None
        hist = snap.get("hist") if isinstance(snap, dict) else None
        if not isinstance(hist, dict):
            continue
        if any(key in hist for key in snapshots):
            contributors += 1
        for key in snapshots:
            if key in hist:
                snapshots[key].append(hist[key])
    for key, col in (("first_token", "ft_ms"), ("inter_token", "it_ms")):
        merged = merge.merge_snapshots(snapshots[key])
        if merged is not None and merge.total(merged) > 0:
            row[col] = (merge.quantile(merged, 0.5) * 1e3,
                        merge.quantile(merged, 0.99) * 1e3)
    # SPREAD doubles as "how many rows fed the fleet fold" — the
    # dash-vs-number that separates a quiet fleet from a pre-upgrade one.
    if contributors:
        row["spread"] = contributors
    return row


def _empty_fleet_row() -> dict:
    return {"id": "ALL", "status": "-", "role": "fleet", "qps": None,
            "tier": None,
            "ft_ms": (None, None), "it_ms": (None, None), "queue": None,
            "slots": None, "cache_hit": None, "prefix_hit": None,
            "pages": None, "kvtier": None, "accept": None, "shard": None,
            "repl_lag": None, "commit_ms": (None, None),
            "pick_ms": (None, None), "spread": None, "events": {}}


class _FleetFold:
    """The --watch session's persistent ALL-row fold: one SnapshotFold
    per latency key, patched ONLY for rows whose beat stamp moved since
    the last refresh (incremental, metered as
    oim_top_merge_seconds{mode=incremental} inside obs/merge.py) —
    fleet_top_row's from-scratch fold re-sums every row every refresh,
    which at 1000 rows costs more than the rest of the render. Rows
    fold at their CURRENT published snapshot (set on change, drop on
    departure — same semantics as the one-shot scratch path, which the
    equivalence test in tests/test_obs_merge.py pins), not the
    SLO plane's monotone departed-epoch banking."""

    _KEYS = (("first_token", "ft_ms"), ("inter_token", "it_ms"))

    def __init__(self):
        from oim_tpu_torch.obs.merge import SnapshotFold

        self._folds = {key: SnapshotFold() for key, _ in self._KEYS}
        self._beats: dict[str, object] = {}
        self._contrib: set[str] = set()

    def row(self, entries) -> dict:
        from oim_tpu_torch.obs import merge

        seen = set()
        for entry in entries:
            rid = entry[0]
            snap = entry[4] if len(entry) > 4 else None
            if not isinstance(snap, dict):
                continue
            seen.add(rid)
            beat = snap.get("beat")
            if beat is not None and self._beats.get(rid) == beat:
                continue  # unchanged since last refresh: zero fold work
            self._beats[rid] = beat
            hist = snap.get("hist")
            hist = hist if isinstance(hist, dict) else {}
            if any(key in hist for key, _ in self._KEYS):
                self._contrib.add(rid)
            else:
                self._contrib.discard(rid)
            for key, _ in self._KEYS:
                self._folds[key].set(rid, hist.get(key))
        for rid in list(self._beats):
            if rid not in seen:
                del self._beats[rid]
                self._contrib.discard(rid)
                for fold in self._folds.values():
                    fold.drop(rid)
        row = _empty_fleet_row()
        for key, col in self._KEYS:
            merged = self._folds[key].merged()
            if merged is not None and merge.total(merged) > 0:
                row[col] = (merge.quantile(merged, 0.5) * 1e3,
                            merge.quantile(merged, 0.99) * 1e3)
        if self._contrib:
            row["spread"] = len(self._contrib)
        return row


def render_top(rows: list[dict]) -> str:
    """The cluster table, one daemon per line."""
    def fmt(v, pattern="{:.2g}"):
        return "-" if v is None else pattern.format(v)

    def fmt_pair(pair):
        p50, p99 = pair
        if p50 is None or p50 != p50:
            return "-"
        return f"{p50:.1f}/{p99:.1f}"

    def fmt_pages(pair):
        if pair is None:
            return "-"
        used, total = pair
        return f"{used:g}/{total:g}"

    def fmt_kvtier(triple):
        # hbm-pages/host-pages, "+N" peer fetches only once any
        # happened (most fleets never peer-fetch; the column should
        # not imply they tried).
        if triple is None:
            return "-"
        hbm, host, peer = triple
        cell = f"{hbm:g}/{host:g}"
        return f"{cell}+{peer:g}" if peer else cell

    # KIND is the process kind (serve/registry/router); ROLE is the
    # serve tier's disaggregation role (prefill/decode/mixed), dashed
    # for non-serve rows and pre-role scrapes.
    headers = ("ID", "KIND", "ROLE", "STATUS", "QPS", "FIRST-TOK(ms)",
               "INTER-TOK(ms)", "QUEUE", "SLOTS", "SHARD", "PAGES",
               "KV-TIER", "ACCEPT", "CACHE-HIT", "PREFIX-HIT",
               "REPL-LAG", "COMMIT(ms)", "PICK(ms)", "SPREAD",
               "EVENTS")
    table = [headers]
    for r in rows:
        top_events = sorted(r["events"].items(),
                            key=lambda kv: -kv[1])[:2]
        table.append((
            r["id"], r["role"], r.get("tier") or "-",
            r["status"], fmt(r["qps"]),
            fmt_pair(r["ft_ms"]), fmt_pair(r["it_ms"]),
            fmt(r["queue"], "{:g}"), fmt(r["slots"]),
            fmt_pages(r.get("shard")),
            fmt_pages(r.get("pages")),
            fmt_kvtier(r.get("kvtier")),
            fmt(r.get("accept"), "{:.0%}"),
            fmt(r["cache_hit"], "{:.0%}"),
            fmt(r.get("prefix_hit"), "{:.0%}"),
            fmt(r["repl_lag"], "{:g}"),
            fmt_pair(r.get("commit_ms", (None, None))),
            fmt_pair(r.get("pick_ms", (None, None))),
            fmt(r["spread"], "{:g}"),
            ",".join(f"{t}:{n}" for t, n in top_events) or "-",
        ))
    widths = [max(len(row[i]) for row in table)
              for i in range(len(headers))]
    return "\n".join(
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row))
        for row in table)


class _PrefixWatch:
    """One background ``Watch(<prefix>)`` stream feeding a cached view:
    the plumbing (thread, resume token, UNIMPLEMENTED degrade, sync
    gate) shared by the --top row watch and the FIRING-banner alert
    watch, so a ``--watch N`` session issues ZERO per-refresh reads.
    Subclasses implement the view callbacks."""

    PREFIX = ""

    def __init__(self, with_failover):
        import threading

        self._with_failover = with_failover
        self._lock = threading.Lock()
        self._synced = threading.Event()
        self._unsupported = threading.Event()
        self._stop = threading.Event()
        self._token = ""
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _parse_body(value: str) -> dict:
        import json

        try:
            body = json.loads(value)
        except ValueError:
            body = {}
        return body if isinstance(body, dict) else {}

    # Subclass view callbacks (called with paths/values off the stream).
    def _install(self, rows: dict) -> None:
        raise NotImplementedError

    def _put(self, path: str, value: str) -> None:
        raise NotImplementedError

    def _delete(self, path: str, expired: bool) -> None:
        raise NotImplementedError

    def _consume(self, stub) -> None:
        # The shared Watch-client state machine (registry/watch.py):
        # RESET batching + resume-token discipline live in ONE place.
        from oim_tpu_torch.registry.watch import WatchConsumer
        from oim_tpu_torch.spec import oim_pb2 as pb

        consumer = WatchConsumer()
        consumer.resume_token = self._token
        try:
            call = stub.Watch(pb.WatchRequest(
                path=self.PREFIX, resume_token=self._token))
            consumer.run(call, install=self._install, put=self._put,
                         delete=self._delete, on_sync=self._synced.set,
                         is_stopped=self._stop.is_set)
        finally:
            self._token = consumer.resume_token

    def _loop(self) -> None:
        import time

        import grpc

        while not self._stop.is_set():
            try:
                self._with_failover(self._consume)
            except grpc.RpcError as err:
                if err.code() == grpc.StatusCode.UNIMPLEMENTED:
                    self._unsupported.set()
                    return
            except Exception:  # noqa: BLE001 - keep the CLI rendering
                pass
            self._synced.clear()
            time.sleep(0.5)

    def usable(self, timeout: float = 0.0) -> bool:
        if self._unsupported.is_set():
            return False
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()


class TelemetryWatch(_PrefixWatch):
    """``--top --watch N`` rides ONE ``Watch("telemetry")`` stream: the
    row set is maintained push-style in a background thread and every
    refresh renders from it, instead of re-issuing two GetValues reads
    per period. EXPIRED rows flip to STALE (the poll path's
    include_stale view) rather than vanishing; DELETE removes. Against
    a pre-Watch registry the stream dies UNIMPLEMENTED and the caller
    degrades to the poll path — the PAGES/ACCEPT mixed-version
    stance."""

    PREFIX = "telemetry"

    def __init__(self, with_failover):
        self._rows: dict[str, tuple[str, str, str, str, dict]] = {}
        super().__init__(with_failover)

    @classmethod
    def _entry(cls, path: str,
               value: str) -> tuple[str, str, str, str, dict]:
        rid = path.partition("/")[2]
        snap = cls._parse_body(value)
        return (rid, "ALIVE", str(snap.get("role", "?")),
                str(snap.get("metrics", "")), snap)

    def _install(self, rows: dict) -> None:
        with self._lock:
            self._rows = {path.partition("/")[2]: self._entry(path, value)
                          for path, value in rows.items()}

    def _put(self, path: str, value: str) -> None:
        with self._lock:
            self._rows[path.partition("/")[2]] = self._entry(path, value)

    def _delete(self, path: str, expired: bool) -> None:
        rid = path.partition("/")[2]
        with self._lock:
            if expired and rid in self._rows:
                # The poll path's include_stale view: an expired
                # row flips STALE instead of vanishing.
                _, _, role, metrics, snap = self._rows[rid]
                self._rows[rid] = (rid, "STALE", role, metrics, snap)
            elif not expired:
                self._rows.pop(rid, None)

    def rows(self) -> list[tuple[str, str, str, str, dict]]:
        with self._lock:
            return [self._rows[k] for k in sorted(self._rows)]


class AlertWatch(_PrefixWatch):
    """The FIRING banner's ``Watch("alert")`` stream: a firing alert
    row lands in the banner the moment the monitor publishes it, an
    expiry (dead monitor) or delete (resolution) clears it — no
    per-refresh GetValues. Exactly the consumer shape the autoscaler
    will use."""

    PREFIX = "alert"

    def __init__(self, with_failover):
        self._alerts: dict[str, dict] = {}
        super().__init__(with_failover)

    def _install(self, rows: dict) -> None:
        with self._lock:
            self._alerts = {
                path.partition("/")[2]: self._parse_body(value)
                for path, value in rows.items()}

    def _put(self, path: str, value: str) -> None:
        with self._lock:
            self._alerts[path.partition("/")[2]] = self._parse_body(value)

    def _delete(self, path: str, expired: bool) -> None:
        # Resolution deletes the row; a dead monitor's rows expire.
        # Either way the alert is no longer being asserted.
        with self._lock:
            self._alerts.pop(path.partition("/")[2], None)

    def rows(self) -> list[tuple[str, dict]]:
        with self._lock:
            return sorted(self._alerts.items())


class FleetWatch(_PrefixWatch):
    """The FLEET banner's ``Watch("fleet")`` stream: the autoscaler's
    TTL-leased desired-state row lands push-style, and an expiry (dead
    autoscaler with no standby) or delete (clean stop) clears it — the
    banner dashing out IS the "nobody is holding the wheel" signal."""

    PREFIX = "fleet"

    def __init__(self, with_failover):
        self._fleet: dict[str, dict] = {}
        super().__init__(with_failover)

    def _install(self, rows: dict) -> None:
        with self._lock:
            self._fleet = {
                path.partition("/")[2]: self._parse_body(value)
                for path, value in rows.items()}

    def _put(self, path: str, value: str) -> None:
        with self._lock:
            self._fleet[path.partition("/")[2]] = self._parse_body(value)

    def _delete(self, path: str, expired: bool) -> None:
        with self._lock:
            self._fleet.pop(path.partition("/")[2], None)

    def rows(self) -> list[tuple[str, dict]]:
        with self._lock:
            return sorted(self._fleet.items())


def fleet_rows(stub) -> list[tuple[str, dict]]:
    """(name, row body) per live ``fleet/<name>`` registry row — the
    TTL-leased desired-state rows the leading oim-autoscaler publishes
    (the lease filter makes a dead autoscaler's claim vanish)."""
    from oim_tpu_torch.common.pathutil import REGISTRY_FLEET
    from oim_tpu_torch.spec import oim_pb2 as pb

    return sorted(
        (value.path.partition("/")[2], _PrefixWatch._parse_body(value.value))
        for value in stub.GetValues(
            pb.GetValuesRequest(path=REGISTRY_FLEET), timeout=10).values)


def fleet_banner(rows) -> str:
    """The --top FLEET line: the autoscaler's declared-vs-actual fleet.
    Every field dash-degrades — no autoscaler row (none deployed, or
    the leader died with no standby), a pre-autoscaler registry, or a
    row missing fields all render as "-" rather than breaking the
    table (the PAGES/ACCEPT mixed-version stance)."""
    body = dict(rows).get("autoscaler") if rows else None
    if not isinstance(body, dict):
        body = {}

    def field(key):
        value = body.get(key)
        return "-" if value is None or value == "" else value

    alerts = body.get("alerts")
    firing = ",".join(alerts) if isinstance(alerts, list) and alerts else "-"
    return (f"FLEET  leader={field('autoscaler')}"
            f"  desired={field('desired')}  ready={field('ready')}"
            f"  min={field('min')}  max={field('max')}"
            f"  version={field('version')}  alerts={firing}")


def alert_rows(stub) -> list[tuple[str, dict]]:
    """(name, alert body) per live ``alert/<name>`` registry row — the
    TTL-leased rows oim-monitor publishes while an SLO burns (the lease
    filter drops a dead monitor's alerts automatically)."""
    from oim_tpu_torch.common.pathutil import REGISTRY_ALERT
    from oim_tpu_torch.spec import oim_pb2 as pb

    return sorted(
        (value.path.partition("/")[2], _PrefixWatch._parse_body(value.value))
        for value in stub.GetValues(
            pb.GetValuesRequest(path=REGISTRY_ALERT), timeout=10).values)


def print_alerts(with_failover) -> None:
    """Render the firing alert rows: one line per alert — burn rates,
    threshold, the objective breached, and how long it has burned."""
    import time

    rows = with_failover(alert_rows)
    if not rows:
        print("no alerts firing (oim-monitor publishes alert/<name> "
              "rows while an SLO's burn rate breaches)")
        return
    for name, body in rows:
        since = body.get("since")
        age = f"{max(time.time() - since, 0):.0f}s" if since else "?"
        detail = ""
        if body.get("kind") == "latency":
            detail = (f" target p{body.get('objective', 0) * 100:.0f}"
                      f"<={float(body.get('threshold_s', 0)) * 1e3:.0f}ms")
        print(f"{name}\tFIRING\tdir={body.get('direction', '?')}"
              f"\tburn_fast={body.get('burn_fast', '?')}"
              f"\tburn_slow={body.get('burn_slow', '?')}"
              f"\tthreshold={body.get('threshold', '?')}"
              f"\tfor={age}{detail}")


def print_autopsy(with_failover, trace_id: str) -> None:
    """One request's phase-attributed timeline: discover the fleet's
    debug endpoints from the live telemetry rows, fan out to
    /debug/spans + /debug/events, and render where the wall time went
    (obs/autopsy.py)."""
    from oim_tpu_torch.obs import autopsy

    entries = with_failover(telemetry_rows)
    # STALE rows ride too: a lease lapse (or a registry blip flipping
    # everything stale) doesn't mean the daemon's /debug endpoints are
    # gone — and a post-mortem autopsy WANTS the dead daemon's spans.
    # collect() already skips genuinely unreachable targets.
    targets = [e[3] for e in entries if e[3]]
    if not targets:
        raise SystemExit(
            "--autopsy: no telemetry/<id> rows advertise a metrics "
            "endpoint to walk")
    try:
        report = autopsy.autopsy(trace_id, targets)
    except ValueError as err:
        raise SystemExit(f"--autopsy: {err}") from err
    print(autopsy.render(report))


def _entry_badness(entry) -> float:
    """Worst-first sort key for --top: a row's first-token p99 from the
    histogram snapshot it already published to the registry — no scrape
    needed, so --limit can trim BEFORE the per-row HTTP fan-out.  Rows
    with no latency histogram (registry/router daemons, cold replicas)
    sort last."""
    from oim_tpu_torch.obs import merge

    snap = entry[4] if len(entry) > 4 else None
    hist = snap.get("hist") if isinstance(snap, dict) else None
    sample = hist.get("first_token") if isinstance(hist, dict) else None
    if sample is None or merge.total(sample) <= 0:
        return float("-inf")
    return merge.quantile(sample, 0.99)


def print_top(with_failover, watch: float = 0.0,
              limit: int = 0) -> None:
    """Poll every advertised telemetry endpoint and render one cluster
    table — a synthesized ALL row (fleet-merged percentiles from the
    rows' histogram snapshots) above the per-daemon rows, and a FIRING
    banner when any alert/<name> row is live; ``watch`` > 0 refreshes
    on that period until interrupted — discovering rows over one Watch
    stream when the registry supports it (one stream for the whole
    session, not two GetValues reads per refresh), degrading to the
    GetValues poll otherwise.  ``limit`` > 0 renders only the N worst
    rows (first-token p99, descending, id tie-break) — the ALL row
    still folds EVERY registered replica, so the fleet percentiles are
    not biased by the trim."""
    import time

    import grpc as grpc_mod

    watcher = TelemetryWatch(with_failover) if watch > 0 else None
    # The banners ride their own streams in watch mode — a --watch
    # session must not re-add per-refresh GetValues reads for alerts
    # (or the fleet row) after the telemetry stream removed the row
    # reads.
    alert_watcher = AlertWatch(with_failover) if watch > 0 else None
    fleet_watcher = FleetWatch(with_failover) if watch > 0 else None
    # Per-session scrape parse cache: a --watch refresh where a row's
    # /metrics text is byte-identical to the previous scrape (idle
    # daemon between beats) skips re-parsing it (top_row checks).
    parse_cache: dict[str, tuple[str, list]] = {}
    # Watch mode folds the ALL row incrementally (only rows whose beat
    # stamp moved are re-merged); one-shot mode scratch-folds once.
    fleet_fold = _FleetFold() if watch > 0 else None
    first = True
    try:
        while True:
            if watcher is not None and watcher.usable(
                    timeout=5.0 if first else 0.0):
                entries = watcher.rows()
            else:
                entries = with_failover(telemetry_rows)
            if alert_watcher is not None and alert_watcher.usable(
                    timeout=2.0 if first else 0.0):
                firing = alert_watcher.rows()
            else:
                try:
                    firing = with_failover(alert_rows)
                except grpc_mod.RpcError:
                    firing = []  # the table must render through a blip
            if fleet_watcher is not None and fleet_watcher.usable(
                    timeout=2.0 if first else 0.0):
                fleet = fleet_watcher.rows()
            else:
                try:
                    fleet = with_failover(fleet_rows)
                except grpc_mod.RpcError:
                    fleet = []  # dash-degrade, never break the table
            first = False
            # The ALL row folds over every entry BEFORE any trim; only
            # the scraped per-daemon rows honor --limit.
            all_row = (fleet_fold.row(entries) if fleet_fold is not None
                       else fleet_top_row(entries)) if entries else None
            shown = sorted(
                entries,
                key=lambda e: (-_entry_badness(e), e[0]))
            if limit > 0:
                shown = shown[:limit]
            rows = [top_row(*entry, parse_cache=parse_cache)
                    for entry in shown]
            if rows:
                rows.insert(0, all_row)
            if watch > 0:
                print("\033[2J\033[H", end="")  # clear + home, like top(1)
            print(fleet_banner(fleet))
            if firing:
                names = ", ".join(name for name, _ in firing)
                print(f"*** FIRING: {names} (oimctl --alerts for "
                      f"detail) ***")
            if rows:
                print(render_top(rows))
            else:
                print("no telemetry/<id> rows registered (daemons "
                      "publish them when run with --metrics-port and "
                      "--registry)")
            if watch <= 0:
                return
            try:
                time.sleep(watch)
            except KeyboardInterrupt:
                return
    finally:
        if watcher is not None:
            watcher.stop()
        if alert_watcher is not None:
            alert_watcher.stop()
        if fleet_watcher is not None:
            fleet_watcher.stop()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("oimctl")
    add_registry_flag(parser)
    parser.add_argument("--get", default=None, metavar="PATH", help="prefix to read")
    parser.add_argument(
        "--stale",
        action="store_true",
        help="include lease-expired entries in --get output",
    )
    parser.add_argument(
        "--set",
        default=None,
        metavar="PATH=VALUE",
        help="key to set (empty VALUE deletes)",
    )
    parser.add_argument(
        "--health",
        action="store_true",
        help="controller liveness table from the registry's lease plane "
             "(plus the registry's own role/lag row when replicated)",
    )
    parser.add_argument(
        "--promote",
        action="store_true",
        help="promote the standby registry to primary (admin CN): probes "
             "the endpoint list for the STANDBY and sends the promote "
             "command there",
    )
    parser.add_argument(
        "--metrics",
        default=None,
        metavar="HOST:PORT",
        help="pretty-print a daemon's GET /metrics scrape (families "
             "grouped, histograms summarized as count/mean/p50/p99); "
             "plain HTTP, no --registry needed",
    )
    parser.add_argument(
        "--events",
        default=None,
        metavar="HOST:PORT",
        help="print a daemon's flight recorder (GET /debug/events): one "
             "line per control-plane event, oldest first; plain HTTP, "
             "no --registry needed",
    )
    parser.add_argument(
        "--trace",
        default="",
        metavar="TRACE_ID",
        help="with --events: only events stamped with this trace_id "
             "(the id an exemplar or span named)",
    )
    parser.add_argument(
        "--type",
        default="",
        metavar="EVENT_TYPE",
        dest="event_type",
        help="with --events: only events of this type "
             "(router_retry, lease_expired, ...)",
    )
    parser.add_argument(
        "--top",
        action="store_true",
        help="live cluster table from the TTL-leased telemetry/<id> "
             "rows: every advertised metrics endpoint is scraped and "
             "rendered as one row (role, qps, first/inter-token "
             "p50/p99, queue, slot occupancy, stage-cache hit rate, "
             "replication lag, router spread, recent event counts)",
    )
    parser.add_argument(
        "--watch",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="with --top: refresh the table on this period until "
             "interrupted (0 = render once). Row discovery rides one "
             "registry Watch stream when available (push deltas, no "
             "per-refresh GetValues); degrades to polling against a "
             "pre-Watch registry",
    )
    parser.add_argument(
        "--limit",
        type=int,
        default=0,
        metavar="N",
        help="with --top: render only the N worst rows (first-token "
             "p99 from each row's published snapshot, descending, id "
             "tie-break; 0 = all). The ALL row still folds every "
             "registered replica, so fleet percentiles are unbiased "
             "by the trim",
    )
    parser.add_argument(
        "--alerts",
        action="store_true",
        help="list the firing SLO alerts (the TTL-leased alert/<name> "
             "rows oim-monitor publishes while a burn rate breaches): "
             "burn_fast/burn_slow, threshold, and how long each has "
             "fired",
    )
    parser.add_argument(
        "--autopsy",
        default=None,
        metavar="TRACE_ID",
        help="phase-attributed latency timeline for one request: fans "
             "out to every live daemon's /debug/spans + /debug/events "
             "(discovered from the telemetry rows) and renders where "
             "the trace's wall time went — router pick + retries, "
             "admission queue, prefill (prefix hit/miss), decode "
             "cadence — with unattributed gap time called out",
    )
    add_common_flags(parser)
    args = parser.parse_args(argv)
    setup_logging(args)
    requested_registry_ops = (
        args.set is not None or args.get is not None or args.health
        or args.promote or args.top or args.alerts
        or args.autopsy is not None)
    if args.metrics is not None:
        print_metrics(args.metrics)
    if args.events is not None:
        print_events(args.events, trace=args.trace, type_=args.event_type)
    if (args.metrics is not None or args.events is not None) \
            and not requested_registry_ops:
        return 0
    if not args.registry:
        raise SystemExit(
            "--registry is required (except with --metrics/--events alone)")
    import grpc

    from oim_tpu_torch.common import channelpool
    from oim_tpu_torch.common.endpoints import FAILOVER_CODES, RegistryEndpoints
    from oim_tpu_torch.spec import oim_pb2 as pb
    from oim_tpu_torch.spec.services import RegistryStub

    tls = load_tls_flags(args, peer_name="component.registry")
    endpoints = RegistryEndpoints(args.registry)

    pool = channelpool.shared()

    def connect(endpoint: str) -> grpc.Channel:
        # Pooled tlsutil.dial: mTLS when configured, the telemetry client
        # interceptor either way (oimctl's calls show up in traces too),
        # and one channel per endpoint across this invocation's commands
        # (--promote's role probes + the follow-up --health reuse it).
        return pool.get(endpoint, tls)

    def with_failover(op):
        """Run ``op(stub)`` against the current endpoint, rotating through
        the list on the failover statuses (dead endpoint / unpromoted
        standby refusing a write). A dead endpoint's pooled channel is
        evicted so a later retry re-dials instead of reusing the corpse."""
        last_err = None
        for _ in range(len(endpoints)):
            try:
                return op(RegistryStub(connect(endpoints.current())))
            except grpc.RpcError as err:
                pool.maybe_evict(err, endpoints.current())
                if err.code() not in FAILOVER_CODES or not endpoints.multiple:
                    raise
                last_err = err
                endpoints.advance()
        raise last_err

    def promote() -> None:
        # Find the standby: promoting a primary is a no-op, and silently
        # sending the command there would print success while no failover
        # happened. No STANDBY in the list -> fail loudly instead.
        roles = {}
        target = None
        for endpoint in endpoints.all():
            try:
                reply = RegistryStub(connect(endpoint)).GetValues(
                    pb.GetValuesRequest(path="registry/role"), timeout=10)
                roles[endpoint] = {v.path: v.value for v in reply.values}.get(
                    "registry/role", "unreplicated")
                if roles[endpoint] == "STANDBY":
                    target = endpoint
                    break
            except grpc.RpcError as err:
                pool.maybe_evict(err, endpoint)
                roles[endpoint] = f"unreachable ({err.code().name})"
        if target is None:
            raise SystemExit(
                "--promote: no STANDBY among the endpoints — nothing to "
                f"promote (saw: {roles})")
        RegistryStub(connect(target)).SetValue(
            pb.SetValueRequest(
                value=pb.Value(path="registry/promote", value="1")),
            timeout=10,
        )
        print(f"promoted {target}")
        # Follow-up ops in this invocation (--set/--get/--health) must hit
        # the NEW primary: the superseded one would still accept a write
        # for the seconds until its next peer probe demotes it — and then
        # discard it in the resync.
        while endpoints.current() != target:
            endpoints.advance()

    if args.promote:
        promote()
    if args.set is not None:
        if "=" not in args.set:
            raise SystemExit("--set needs PATH=VALUE")
        path, value = args.set.split("=", 1)
        with_failover(lambda stub: stub.SetValue(
            pb.SetValueRequest(value=pb.Value(path=path, value=value)),
            timeout=10,
        ))
    if args.get is not None:
        reply = with_failover(lambda stub: stub.GetValues(
            pb.GetValuesRequest(path=args.get, include_stale=args.stale),
            timeout=10,
        ))
        for value in reply.values:
            print(f"{value.path}={value.value}")
    if args.health:
        def table(stub):
            return (registry_health_row(stub), health_rows(stub),
                    serve_health_rows(stub))

        registry_row, rows, serve_rows = with_failover(table)
        if registry_row is not None:
            print("\t".join(registry_row))
        for cid, status, address, mesh in rows:
            print(f"{cid}\t{status}\t{address}\t{mesh}")
        for key, status, endpoint, load in serve_rows:
            print(f"{key}\t{status}\t{endpoint}\t{load}")
    if args.alerts:
        print_alerts(with_failover)
    if args.autopsy is not None:
        print_autopsy(with_failover, args.autopsy)
    if args.top:
        print_top(with_failover, watch=args.watch, limit=args.limit)
    if not requested_registry_ops and args.metrics is None \
            and args.events is None:
        raise SystemExit(
            "nothing to do: pass --get, --set, --health, --promote, "
            "--top, --alerts, --autopsy, --metrics and/or --events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
