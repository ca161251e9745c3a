"""Metrics (``oim_tpu/common/metrics.py``): thread-safe counters, gauges
and histograms, Prometheus and OpenMetrics text, and an HTTP endpoint.

The machinery is the JAX package's, unchanged: label families
(``.labels(kind=...)`` memoizes a child), per-bucket OpenMetrics trace_id
exemplars on histograms, mergeable snapshots, and ``MetricsServer``
serving ``GET /metrics`` (content-negotiated), ``GET /debug/spans`` (the
port's span ring, ``common/tracing.py``) and ``GET /debug/events`` (its
flight recorder, ``common/events.py``). The same calls on a fresh
``Registry`` of either package render byte-identical text.

The port declares only the families its own modules record: staging and
the stage cache (``controller/``, ``data/staging.py``,
``data/objectstore.py``), the trainer's gauges (``train/trainer.py``),
the serving engine, page pool, prefix store and host tier (``serve/``),
the control plane (the controller, the feeder, the channel pool and the
RPC interceptors), the registry and its replication (``registry/``), the
request router (``router/``), the flight recorder's counter, the fleet
histogram merge (``obs/merge.py``), the SLO engine (``obs/slo.py``) and
the autoscaler (``autoscale/daemon.py``).
Each equals its JAX namesake in name, type, help, label names and
buckets.
"""

from __future__ import annotations

import http.server
import threading
import time
from typing import Iterable, Sequence

# go-grpc-prometheus / prometheus-client default latency buckets (seconds).
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def escape_help(text: str) -> str:
    """Prometheus text-format HELP escaping: backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    """Label-value escaping: backslash, double-quote, newline."""
    return (text.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_bound(value: float) -> str:
    """le-label formatting: integral bounds without the '.0' (the
    prometheus-client convention for bucket bounds)."""
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: str = "") -> str:
    pairs = [f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _CounterValue:
    """One sample (a labels() child, or the whole unlabeled metric)."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def sample_lines(self, name: str, labels: str,
                     exemplars: bool = False) -> Iterable[str]:
        # Plain float formatting ("42.0"): the pre-label wire format,
        # which scrapers and tests already depend on.
        yield f"{name}{labels} {self.value}"


class _GaugeValue(_CounterValue):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = value


class _HistogramValue:
    def __init__(self, buckets: Sequence[float]) -> None:
        self._buckets = tuple(buckets)
        self._counts = [0] * len(self._buckets)
        self._sum = 0.0
        self._count = 0
        # Last exemplar per bucket (index len(buckets) = +Inf): the
        # OpenMetrics trace anchor — (trace_id, observed value, unix ts).
        # Keeping only the most recent costs O(buckets) memory and is
        # exactly the prometheus-client behavior.
        self._exemplars: dict[int, tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: str = "") -> None:
        import bisect

        # _counts[i] is the count landing in (buckets[i-1], buckets[i]];
        # values above the last bound count only in +Inf (== _count).
        with self._lock:
            self._sum += value
            self._count += 1
            i = bisect.bisect_left(self._buckets, value)
            if i < len(self._counts):
                self._counts[i] += 1
            if exemplar:
                self._exemplars[min(i, len(self._counts))] = (
                    exemplar, value, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_snapshot(self) -> tuple[tuple[float, ...],
                                       tuple[int, ...], int]:
        """(bucket upper bounds, per-bucket counts, total count) — the
        raw data in-process quantile estimation needs (bench.py reads
        engine-side percentiles off the live histogram without a
        /metrics scrape; per-bucket counts are NON-cumulative, values
        above the last bound appear only in the total)."""
        with self._lock:
            return tuple(self._buckets), tuple(self._counts), self._count

    def snapshot(self) -> dict:
        """The MERGEABLE wire snapshot (obs/merge.py format): shared
        ``le`` grid, CUMULATIVE counts with the +Inf total last, and the
        observation sum — what telemetry rows publish so the fleet SLO
        plane can fold N replicas into one true fleet histogram."""
        with self._lock:
            counts = list(self._counts)
            total, total_sum = self._count, self._sum
        cumulative, running = [], 0
        for n in counts:
            running += n
            cumulative.append(running)
        cumulative.append(total)
        return {"le": list(self._buckets), "counts": cumulative,
                "sum": total_sum}

    @staticmethod
    def _exemplar_suffix(ex: tuple[str, float, float] | None) -> str:
        # OpenMetrics exemplar: `# {trace_id="..."} <value> <timestamp>`.
        # Appended to the Prometheus text line — OpenMetrics-aware
        # scrapers pick the trace anchor up, plain-text ones must
        # tolerate/strip it (oimctl's parser and the test grammar do).
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
                f"{value:.6g} {ts:.3f}")

    def sample_lines(self, name: str, labels: str,
                     exemplars: bool = False) -> Iterable[str]:
        with self._lock:
            counts = list(self._counts)
            total, total_sum = self._count, self._sum
            anchors = dict(self._exemplars) if exemplars else {}
        # labels arrives rendered ("{a=\"x\"}" or ""); the le label merges
        # inside the braces per the text-format grammar.
        inner = labels[1:-1] if labels else ""
        cumulative = 0
        for i, (bound, n) in enumerate(zip(self._buckets, counts)):
            cumulative += n
            le = f'le="{_fmt_bound(bound)}"'
            merged = "{" + (inner + "," if inner else "") + le + "}"
            yield (f"{name}_bucket{merged} {cumulative}"
                   f"{self._exemplar_suffix(anchors.get(i))}")
        merged = "{" + (inner + "," if inner else "") + 'le="+Inf"' + "}"
        yield (f"{name}_bucket{merged} {total}"
               f"{self._exemplar_suffix(anchors.get(len(counts)))}")
        yield f"{name}_sum{labels} {total_sum}"
        yield f"{name}_count{labels} {total}"


class Counter:
    """A counter family; without labelnames it is its own single sample."""

    TYPE = "counter"

    def __init__(self, name: str, help_: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], object] = {}
        self._family_lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_value()

    def _new_value(self):
        return _CounterValue()

    def labels(self, *values: object, **kwvalues: object):
        if kwvalues:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(kwvalues.pop(n) for n in self.labelnames)
            except KeyError as err:
                raise ValueError(
                    f"{self.name}: missing label {err.args[0]!r}") from None
            if kwvalues:
                raise ValueError(
                    f"{self.name}: unknown labels {sorted(kwvalues)}")
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {key}")
        with self._family_lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_value()
        return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()")
        return self._children[()]

    def labeled_values(self) -> dict[tuple[str, ...], float]:
        """label-values tuple -> current value, for every child (the
        programmatic read telemetry snapshots use; () keys the sole
        child of an unlabeled metric)."""
        with self._family_lock:
            children = list(self._children.items())
        return {key: child.value for key, child in children}

    # Unlabeled passthroughs (the original API).
    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    @property
    def value(self) -> float:
        return self._solo().value

    def render(self, exemplars: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {escape_help(self.help)}"
        yield f"# TYPE {self.name} {self.TYPE}"
        with self._family_lock:
            children = sorted(self._children.items())
        for key, child in children:
            yield from child.sample_lines(
                self.name, _label_str(self.labelnames, key), exemplars)


class Gauge(Counter):
    TYPE = "gauge"

    def _new_value(self):
        return _GaugeValue()

    def set(self, value: float) -> None:
        self._solo().set(value)


class Histogram(Counter):
    TYPE = "histogram"

    def __init__(self, name: str, help_: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        super().__init__(name, help_, labelnames)

    def _new_value(self):
        return _HistogramValue(self.buckets)

    def observe(self, value: float, exemplar: str = "") -> None:
        self._solo().observe(value, exemplar)

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum

    # A histogram family's aggregate value is its observation count.
    @property
    def value(self) -> float:
        return float(self._solo().count)

    def merged_snapshot(self, label_filter: dict | None = None,
                        skip=None) -> dict:
        """One mergeable snapshot (obs/merge.py format) summing every
        child whose labels match ``label_filter`` (None = all children);
        ``skip(labels) -> bool`` excludes children (the telemetry
        payload drops the row-renewal RPCs that would otherwise make
        every snapshot differ from the last). Children of one family
        share the bucket grid by construction, so the sum is exact —
        this is how a labeled histogram (token latency by kind, RPC
        latency by method/code) publishes ONE fleet-mergeable series
        per telemetry row."""
        want = {k: str(v) for k, v in (label_filter or {}).items()}
        with self._family_lock:
            children = list(self._children.items())
        out: dict | None = None
        for key, child in children:
            labels = dict(zip(self.labelnames, key))
            if any(labels.get(k) != v for k, v in want.items()):
                continue
            if skip is not None and skip(labels):
                continue
            snap = child.snapshot()
            if out is None:
                out = snap
            else:
                out["counts"] = [a + b for a, b in
                                 zip(out["counts"], snap["counts"])]
                out["sum"] += snap["sum"]
        if out is None:
            counts = [0] * (len(self.buckets) + 1)
            out = {"le": list(self.buckets), "counts": counts, "sum": 0.0}
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(name, help_, Counter, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(name, help_, Gauge, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, help_, Histogram, labelnames, buckets)

    def _get(self, name, help_, cls, labelnames=(), buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if cls is Histogram:
                    m = cls(name, help_, labelnames, buckets)
                else:
                    m = cls(name, help_, labelnames)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as {type(m).__name__}")
            elif m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}")
            elif (cls is Histogram
                  and m.buckets != tuple(sorted(buckets))):
                # A second registration with different buckets would get
                # the first family's bounds — its quantile estimates would
                # be silently wrong. Fail like a label mismatch does.
                raise ValueError(
                    f"metric {name!r} already registered with buckets "
                    f"{m.buckets}")
            return m

    def render(self, exemplars: bool = False) -> str:
        """Prometheus text format; ``exemplars=True`` adds the
        OpenMetrics ``# {trace_id="…"}`` suffixes on histogram bucket
        lines. Exemplars are ONLY legal in the OpenMetrics exposition
        format — the metrics server content-negotiates on the scrape's
        Accept header, so a legacy Prometheus text parser never sees
        them (one suffix would poison its whole scrape)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render(exemplars))
        return "\n".join(lines) + "\n"


DEFAULT = Registry()

# Canonical framework metrics (names are API).
# Staging (data/staging.py, data/objectstore.py, controller/*_backend.py)
# and the content-addressed stage cache (controller/stagecache.py).
STAGED_BYTES = DEFAULT.counter(
    "oim_staged_bytes_total", "bytes staged into the backend memory domain")
STAGE_SECONDS = DEFAULT.counter(
    "oim_stage_seconds_total", "wall seconds spent staging")
STAGE_GBPS = DEFAULT.gauge(
    "oim_stage_gbps", "throughput of the most recent staging operation")
STAGE_WAIT_SECONDS = DEFAULT.histogram(
    "oim_stage_wait_seconds",
    "time a feeder publish spent polling StageStatus until the volume "
    "materialized (publish latency attributable to staging + polling)")
STAGE_CACHE_HITS = DEFAULT.counter(
    "oim_stage_cache_hits_total",
    "publishes served a resident staged array by content address, "
    "without re-reading the source")
STAGE_CACHE_MISSES = DEFAULT.counter(
    "oim_stage_cache_misses_total",
    "publishes that staged from source (no resident entry for the "
    "content key)")
STAGE_CACHE_EVICTIONS = DEFAULT.counter(
    "oim_stage_cache_evictions_total",
    "stage-cache entries evicted (LRU capacity pressure, stale source "
    "fingerprints, or keep_cached=false unmaps)")
STAGE_CACHE_BYTES = DEFAULT.gauge(
    "oim_stage_cache_bytes", "bytes resident in the stage cache")
STAGE_CACHE_ENTRIES = DEFAULT.gauge(
    "oim_stage_cache_entries", "entries resident in the stage cache")
# The trainer (train/trainer.py), set at each logged step and eval pass.
TRAIN_STEP_SECONDS = DEFAULT.gauge(
    "oim_train_step_seconds", "duration of the most recent training step")
TRAIN_EXAMPLES_PER_SEC = DEFAULT.gauge(
    "oim_train_examples_per_sec", "examples/sec of the most recent step")
TRAIN_MFU = DEFAULT.gauge(
    "oim_train_mfu", "model flops utilization of the most recent step")
EVAL_LOSS = DEFAULT.gauge(
    "oim_eval_loss", "mean loss of the most recent evaluation pass")
EVAL_ACCURACY = DEFAULT.gauge(
    "oim_eval_accuracy",
    "mean classification accuracy of the most recent evaluation pass")
FEED_WAIT_SECONDS = DEFAULT.gauge(
    "oim_feed_wait_seconds",
    "host time blocked waiting on the input feed per step (input-bound "
    "when this approaches oim_train_step_seconds)")
MOE_DROP_FRAC = DEFAULT.gauge(
    "oim_moe_drop_fraction",
    "share of MoE routing assignments dropped for capacity in the most "
    "recent step (mean over layers; the capacity_factor quality signal)")
# Serving plane (serve/engine.py: the continuous-batching engine).
SERVE_QPS = DEFAULT.gauge(
    "oim_serve_qps",
    "completed Generate requests per second over the engine's sliding "
    "window (all outcomes)")
SERVE_QUEUE_DEPTH = DEFAULT.gauge(
    "oim_serve_queue_depth",
    "requests waiting in the admission queue (queue full => new requests "
    "are refused RESOURCE_EXHAUSTED)")
SERVE_SLOT_OCCUPANCY = DEFAULT.gauge(
    "oim_serve_slot_occupancy",
    "fraction of decode-batch slots holding a live request (1.0 = the "
    "continuous batch is full)")
SERVE_REQUESTS_TOTAL = DEFAULT.counter(
    "oim_serve_requests_total",
    "Generate requests finished, by outcome: eos | length | cancelled | "
    "drained | rejected",
    labelnames=("outcome",))
SERVE_TOKENS_TOTAL = DEFAULT.counter(
    "oim_serve_tokens_total", "tokens emitted by the serving engine")
SERVE_TOKEN_LATENCY = DEFAULT.histogram(
    "oim_serve_token_latency_seconds",
    "latency of each emitted token, by kind: first = submit-to-first-"
    "token (queue wait + prefill, the latency SLO), next = inter-token "
    "decode gap — split so `oimctl --top` reads both percentiles off "
    "one scrape; buckets carry OpenMetrics trace_id exemplars",
    labelnames=("kind",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
SERVE_QUEUE_WAIT = DEFAULT.histogram(
    "oim_serve_queue_wait_seconds",
    "time a request spent in the admission queue before its prefill "
    "started (the backpressure half of first-token latency; buckets "
    "carry OpenMetrics trace_id exemplars)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 10.0))
SERVE_FIRST_TOKEN = DEFAULT.histogram(
    "oim_serve_first_token_seconds",
    "submit-to-first-token latency split by prefix-cache outcome "
    "(prefix=hit|miss), so the cache's latency win is one scrape away; "
    "buckets carry OpenMetrics trace_id exemplars",
    labelnames=("prefix",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
# Prefix KV cache (serve/prefixcache.py).
SERVE_PREFIX_HITS = DEFAULT.counter(
    "oim_serve_prefix_hits_total",
    "admissions that copied a cached prompt-prefix K/V into the slot "
    "and prefilled only the uncached tail")
SERVE_PREFIX_MISSES = DEFAULT.counter(
    "oim_serve_prefix_misses_total",
    "admissions that prefilled the whole prompt (no cached prefix "
    "block matched)")
SERVE_PREFIX_CACHE_BYTES = DEFAULT.gauge(
    "oim_serve_prefix_cache_bytes",
    "K/V bytes resident in the prefix cache")
SERVE_PREFILL_TOKENS = DEFAULT.counter(
    "oim_serve_prefill_tokens_total",
    "prompt tokens admitted, by how their K/V materialized: cache = "
    "copied from the prefix store (prefill skipped), compute = forwarded "
    "through the model",
    labelnames=("source",))
# Paged KV cache (serve/pagepool.py): the pool every slot's page table
# maps into; shared = pages referenced more than once (prefix sharing).
SERVE_KV_PAGES_TOTAL = DEFAULT.gauge(
    "oim_serve_kv_pages_total",
    "KV pages in the replica's page pool (capacity; excludes the "
    "reserved scratch page)")
SERVE_KV_PAGES_USED = DEFAULT.gauge(
    "oim_serve_kv_pages_used",
    "KV pages currently referenced by a live slot or the prefix store")
SERVE_KV_PAGES_SHARED = DEFAULT.gauge(
    "oim_serve_kv_pages_shared",
    "KV pages with more than one reference — prompt-prefix pages shared "
    "zero-copy between slots and/or the prefix store")
# KV tiering (serve/kvtier.py): cold prefix chains demote device ->
# host RAM instead of dropping; a later hit re-stages them H2D.
KVTIER_HBM_PAGES = DEFAULT.gauge(
    "oim_kvtier_hbm_pages",
    "prefix KV pages resident in the HBM tier (the prefix store's "
    "entry count; one page per block)")
KVTIER_HOST_PAGES = DEFAULT.gauge(
    "oim_kvtier_host_pages",
    "prefix KV pages resident in the host-RAM tier (demoted from HBM, "
    "promotable back on a chain hit)")
KVTIER_HOST_BYTES = DEFAULT.gauge(
    "oim_kvtier_host_bytes",
    "K/V bytes resident in the host-RAM tier (bounded by "
    "--kv-host-bytes)")
KVTIER_DEMOTIONS = DEFAULT.counter(
    "oim_kvtier_demotions_total",
    "prefix pages demoted HBM -> host RAM (D2H on eviction pressure "
    "instead of dropping the chain)")
KVTIER_PROMOTIONS = DEFAULT.counter(
    "oim_kvtier_promotions_total",
    "prefix pages promoted host RAM -> HBM (H2D re-stage on a chain "
    "hit)")
KVTIER_EXPORTS = DEFAULT.counter(
    "oim_kvtier_exports_total",
    "prefix chains exported as content-addressed KV-page volumes "
    "(serve/kvvolume.py pack -> feeder publish)")
# Fleet prefix sharing: a replica adopting finished KV pages fetched
# from a peer's exported chain volume instead of re-prefilling.
SERVE_PREFIX_PEER_FETCHES = DEFAULT.counter(
    "oim_serve_prefix_peer_fetches_total",
    "peer prefix-fetch attempts, by outcome: hit = blocks fetched and "
    "adoptable, miss = no peer volume covers the chain, error = fetch "
    "started but failed (the engine recomputes locally either way)",
    labelnames=("outcome",))
SERVE_PREFIX_PEER_TOKENS = DEFAULT.counter(
    "oim_serve_prefix_peer_tokens_total",
    "prompt tokens whose K/V was adopted from a peer-exported chain "
    "volume instead of local prefill or the local prefix store")
# Speculative decoding (serve/spec.py).
SERVE_SPEC_PROPOSED = DEFAULT.counter(
    "oim_serve_spec_proposed_tokens_total",
    "draft-model tokens proposed to the target verify pass (K per "
    "speculating slot per verify round)")
SERVE_SPEC_ACCEPTED = DEFAULT.counter(
    "oim_serve_spec_accepted_tokens_total",
    "proposed draft tokens the target accepted (greedy: proposal == "
    "target argmax; sampled: the ratio test passed); accepted/proposed "
    "is the LIFETIME ratio — the adaptive valve's rolling window is "
    "oim_serve_spec_accept_rolling")
SERVE_SPEC_ACCEPT_ROLLING = DEFAULT.gauge(
    "oim_serve_spec_accept_rolling",
    "acceptance rate over the adaptive valve's rolling window of "
    "verify rounds — what the fallback decision and oimctl --top's "
    "ACCEPT column actually track (a healthy lifetime ratio can mask "
    "a draft that stopped predicting the current traffic)")
SERVE_SPEC_FALLBACK = DEFAULT.counter(
    "oim_serve_spec_fallback_total",
    "times the adaptive valve disabled speculation because the rolling "
    "acceptance rate fell below the floor (the engine decodes plainly "
    "until the re-probe cooldown lapses)")
# Tensor-parallel serving (serve/shard.py): one logical replica spans N
# member processes over ICI; member TTL leases under
# serve/<id>.member.<k> feed the ready/stale split, and the allreduce
# probe times one compiled psum over the same tp mesh per target
# dispatch (the fused per-layer collectives cannot be host-timed).
SERVE_SHARD_MEMBERS = DEFAULT.gauge(
    "oim_serve_shard_members",
    "member processes of this sharded replica by lease state: ready = "
    "TTL lease live, stale = lease lapsed but the row not yet swept "
    "(any stale member flips the replica not-ready)",
    labelnames=("state",))
SERVE_ICI_ALLREDUCE = DEFAULT.histogram(
    "oim_serve_ici_allreduce_seconds",
    "one tp-mesh allreduce (compiled psum probe timed once per target "
    "dispatch on sharded replicas); buckets carry trace_id exemplars "
    "linking a slow collective to the request it stalled",
    buckets=(0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
             0.001, 0.0025, 0.005, 0.01, 0.05))
# Prefill/decode disaggregation: replicas specialize by phase and the
# router splits a request across tiers — prefill runs big-batch chunked
# prefill and ships the finished chain as a content-addressed kvchain
# volume; the decode pick adopts the pages instead of recomputing.
SERVE_ROLE = DEFAULT.gauge(
    "oim_serve_role",
    "info gauge: the label whose sample is 1 names this replica's "
    "serving role (prefill = big-batch prompt tier that exports "
    "finished chains, decode = occupancy-packed stream tier, mixed = "
    "unified legacy behavior); advertised in the heartbeat snapshot "
    "and rendered as oimctl --top's ROLE column",
    labelnames=("role",))
SERVE_PREFILL_HANDOFFS = DEFAULT.counter(
    "oim_serve_prefill_handoffs_total",
    "prefill-tier handoff outcomes: split = router sent the prompt to "
    "a prefill pick before streaming from decode, exported = the "
    "retired chain was published as a kvchain volume, skipped = "
    "nothing exportable (prompt shorter than one block, or the volume "
    "already published), export_failed / fallback = the defect paths "
    "that degrade to decode-local prefill (never a wrong resume)",
    labelnames=("outcome",))
SERVE_PREFILL_CHUNK_SECONDS = DEFAULT.histogram(
    "oim_serve_prefill_chunk_seconds",
    "one --prefill-chunk slice of a long prompt's prefill (device-sync "
    "included) — the bound on how long a resident stream's decode "
    "cadence can stall behind prompt work between interleaved steps",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5))
# Control plane (controller/controller.py, feeder/driver.py,
# common/channelpool.py, common/rpctelemetry.py).
HEARTBEAT_RTT = DEFAULT.gauge(
    "oim_heartbeat_rtt_seconds",
    "round-trip time of the controller's most recent registry heartbeat")
FEEDER_FAILOVERS = DEFAULT.counter(
    "oim_feeder_failovers_total",
    "feeder re-targets to a different controller serving the same mesh "
    "coordinate after the pinned controller became unavailable")
WINDOW_PATH_TOTAL = DEFAULT.counter(
    "oim_window_path_total",
    "data windows served, by path: direct = feeder dialed the owning "
    "controller's registered endpoint; proxy = streamed through the "
    "registry's transparent proxy (first contact, direct-dial failure, "
    "or direct_data=False)",
    labelnames=("path",))
WINDOW_GBPS = DEFAULT.histogram(
    "oim_window_gbps",
    "throughput of each remote data-window read (window bytes / wall "
    "seconds, GB/s), both paths",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0,
             16.0, 32.0))
CHANNEL_POOL_SIZE = DEFAULT.gauge(
    "oim_channel_pool_size",
    "live pooled gRPC channels across every ChannelPool in this process")
RPC_LATENCY = DEFAULT.histogram(
    "oim_rpc_latency_seconds",
    "gRPC call latency by method and final status code (streaming calls "
    "time the whole stream)",
    labelnames=("method", "code"))
RPC_TOTAL = DEFAULT.counter(
    "oim_rpc_total",
    "gRPC calls completed, by method and final status code",
    labelnames=("method", "code"))
# The registry (registry/: leases, the replicated pair, the quorum and
# its Watch streams) and the request router (router/).
LEASE_EXPIRIES = DEFAULT.counter(
    "oim_lease_expiries_total",
    "registry entries that crossed from live to expired (counted once per "
    "expiry, when a read first observes the entry stale)")
PROXY_FASTFAILS = DEFAULT.counter(
    "oim_proxy_fastfail_total",
    "proxied calls refused without dialing because the target controller's "
    "lease had expired")
REPL_LAG_RECORDS = DEFAULT.gauge(
    "oim_replication_lag_records",
    "journal records the standby has not yet applied (primary next offset "
    "minus standby applied offset)")
REPL_LAG_SECONDS = DEFAULT.gauge(
    "oim_replication_lag_seconds",
    "seconds since the standby last received a record (data or primary "
    "self-heartbeat) over the replication stream")
REPL_RECORDS_APPLIED = DEFAULT.counter(
    "oim_replication_records_applied_total",
    "replication records (KV mutations, lease renewals, snapshot entries) "
    "applied by this registry as a standby")
REGISTRY_PROMOTIONS = DEFAULT.counter(
    "oim_registry_promotions_total",
    "standby-to-primary promotions performed by this registry process "
    "(admin --promote or primary self-lease expiry)")
REGISTRY_ROLE = DEFAULT.gauge(
    "oim_registry_role",
    "replication role of this registry: 1 = PRIMARY/LEADER, "
    "0 = STANDBY/FOLLOWER/CANDIDATE")
REGISTRY_TERM = DEFAULT.gauge(
    "oim_registry_term",
    "current raft-style election term of this quorum registry member "
    "(the promotion-epoch analog; 0 on an unreplicated or pair-mode "
    "registry)")
REGISTRY_COMMIT_INDEX = DEFAULT.gauge(
    "oim_registry_commit_index",
    "journal offset below which records are quorum-acknowledged on this "
    "member (writes are client-visible only once committed)")
REGISTRY_GETVALUES = DEFAULT.counter(
    "oim_registry_getvalues_total",
    "GetValues reads served by this registry — the poll load Watch "
    "streams exist to remove (bench.py --control-plane measures the "
    "drop at 1k publishers)")
WATCH_STREAMS = DEFAULT.gauge(
    "oim_watch_streams",
    "Watch streams currently attached to this registry")
WATCH_EVENTS = DEFAULT.counter(
    "oim_watch_events_total",
    "Watch events delivered to consumers, by kind "
    "(put/delete/expired/sync)",
    labelnames=("kind",))
WATCH_FANOUT_SECONDS = DEFAULT.histogram(
    "oim_watch_fanout_seconds",
    "wall seconds one committed delta took to serialize (once) and "
    "enqueue onto every attached Watch stream — the write path's "
    "fan-out tax; bucket exemplars carry the mutation's trace id",
    buckets=(0.000001, 0.0000025, 0.000005, 0.00001, 0.000025, 0.00005,
             0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05,
             0.25))
WATCH_QUEUE_DEPTH = DEFAULT.gauge(
    "oim_watch_queue_depth_peak",
    "deepest per-stream Watch queue observed at the most recent "
    "fan-out (0 = every consumer keeping up; approaching queue_max = "
    "a shed is imminent)")
WATCH_SHED_STREAMS = DEFAULT.counter(
    "oim_watch_shed_streams_total",
    "Watch streams closed because a slow consumer overflowed its "
    "bounded queue (each shed also lands a watch_stream_shed flight-"
    "recorder event with the prefix and queue high-water mark)")
REGISTRY_COMMIT_SECONDS = DEFAULT.histogram(
    "oim_registry_commit_seconds",
    "quorum write pipeline on the leader, by phase: ack = append until "
    "a majority holds the record, apply = majority-ack until the DB "
    "mutation (and its Watch fan-out) lands, total = append until "
    "client-visible; exemplars carry the proposing RPC's trace id",
    labelnames=("phase",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))
REGISTRY_ELECTION_SECONDS = DEFAULT.histogram(
    "oim_registry_election_seconds",
    "campaign start to leadership on this member (won elections only) "
    "— the convergence half of leader-kill recovery; the other half is "
    "the election timeout that started the campaign",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
REGISTRY_READ_LAG = DEFAULT.gauge(
    "oim_registry_read_lag_records",
    "committed records this follower has not yet applied (received-"
    "but-unflushed + known-committed-but-unreceived): the raft read-"
    "index gap — a follower GetValues can trail the leader's commit "
    "by one ack round-trip (doc/architecture.md, Control plane at "
    "scale); 0 on leaders")
ROUTER_PICK_SECONDS = DEFAULT.histogram(
    "oim_router_pick_seconds",
    "wall seconds one router pick spent scoring the replica table "
    "(affinity hash + least-loaded scan) — linear in table rows, the "
    "per-request control-plane tax bench.py --control-plane curves at "
    "10/100/1000 rows",
    buckets=(0.000001, 0.0000025, 0.000005, 0.00001, 0.000025, 0.00005,
             0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.01))
ROUTER_REQUESTS_TOTAL = DEFAULT.counter(
    "oim_router_requests_total",
    "routed Generate attempts, by replica and outcome: a finish_reason "
    "(eos/length/...) for completed streams, retried = failed before the "
    "first token and moved to the next replica, error = surfaced to the "
    "client, cancelled = client went away, unroutable = empty table",
    labelnames=("replica", "outcome"))
ROUTER_RETRIES_TOTAL = DEFAULT.counter(
    "oim_router_retries_total",
    "pre-first-token failovers to the next replica "
    "(RESOURCE_EXHAUSTED/UNAVAILABLE from the first pick)")
ROUTER_REPLICAS = DEFAULT.gauge(
    "oim_router_replicas",
    "ready serve replicas in the router's lease-filtered routing table")
ROUTER_AFFINITY_PICKS = DEFAULT.counter(
    "oim_router_affinity_picks_total",
    "picks herded to a replica advertising the request's prompt-prefix "
    "hash instead of the plain least-loaded choice (only taken when the "
    "holder's backlog is within the affinity load guard)")
# Flight recorder (common/events.py): the counter survives ring wrap.
EVENTS_TOTAL = DEFAULT.counter(
    "oim_events_total",
    "flight-recorder events emitted, by type (lease_expired, "
    "feeder_failover, registry_promotion, router_retry, replica_drain, "
    "stage_cache_eviction, slot_evicted, ...)",
    labelnames=("type",))
# Fleet histogram merge (obs/merge.py): one fold, timed by mode.
TOP_MERGE_SECONDS = DEFAULT.histogram(
    "oim_top_merge_seconds",
    "one fleet-histogram fold (obs/merge.py) by mode: scratch = "
    "re-merge every contributor snapshot, incremental = apply only "
    "changed rows to the running per-grid aggregate (what --top "
    "--watch re-renders cost)",
    labelnames=("mode",),
    buckets=(0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
             0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25))
# Fleet SLO plane (obs/slo.py: burn rates over fleet-merged telemetry
# snapshots; the oim-monitor daemon records these).
SLO_BURN_RATE = DEFAULT.gauge(
    "oim_slo_burn_rate",
    "fast-window error-budget burn rate per declared SLO (bad_fraction "
    "/ error_budget over the fast window; the alert condition ANDs this "
    "with the slow window — Google-SRE multi-window burn)",
    labelnames=("slo",))
SLO_ALERTS_FIRING = DEFAULT.gauge(
    "oim_slo_alerts_firing",
    "SLO alerts currently in a firing episode on this monitor (each is "
    "mirrored as a TTL-leased alert/<name> registry row)")
# Fleet actuator (autoscale/daemon.py: the SLO-driven reconcile loop; the
# oim-autoscaler daemon records these while it holds leadership).
AUTOSCALE_REPLICAS_DESIRED = DEFAULT.gauge(
    "oim_autoscale_replicas_desired",
    "the reconciler's current replica target: the declared minimum, "
    "stepped up one per cooldown while an alert/ row fires and decayed "
    "back after the alert-free hold (mirrored in the fleet/ desired-"
    "state row `oimctl --top` banners)")
AUTOSCALE_REPLICAS_READY = DEFAULT.gauge(
    "oim_autoscale_replicas_ready",
    "serve/ rows the autoscaler observes ready:true — desired minus "
    "ready is the fleet's actuation lag, the gap bench.py --autoscale "
    "times end to end")
AUTOSCALE_ACTIONS_TOTAL = DEFAULT.counter(
    "oim_autoscale_actions_total",
    "reconcile actions executed through the ReplicaLauncher, by action "
    "(spawn = boot a replica toward the target, drain = SIGTERM-contract "
    "drain of the worst-scoring replica; upgrade flips are a spawn + a "
    "drain with reason=upgrade)",
    labelnames=("action",))
AUTOSCALE_ALERT_TO_READY = DEFAULT.histogram(
    "oim_autoscale_alert_to_ready_seconds",
    "seconds from an alert/ row first observed to every replica of the "
    "raised target heartbeating ready:true — THE number the prestaged "
    "O(1) boot path exists to minimize (spawn/prestage/first-ready "
    "breakdown in bench.py --autoscale)",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0))


class MetricsServer:
    """Serves ``registry.render()`` on ``GET /metrics``, the tracing
    ring buffer on ``GET /debug/spans``, and the flight recorder on
    ``GET /debug/events`` (``?trace=<id>``, ``?type=<t>``, ``?limit=<n>``
    filters) in a daemon thread.

    ``host`` defaults to loopback (the safe standalone default); daemons
    that Prometheus scrapes from another pod bind ``--metrics-host
    0.0.0.0`` (deploy/kubernetes annotations point the scraper here)."""

    def __init__(self, registry: Registry | None = None, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry or DEFAULT
        registry_ref = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, body: bytes, content_type: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                import urllib.parse

                parsed = urllib.parse.urlsplit(self.path)
                if parsed.path == "/metrics":
                    # Content negotiation: exemplars are only legal in
                    # the OpenMetrics exposition format (which also
                    # requires the # EOF trailer). A scraper that asks
                    # for it (Prometheus does by default) gets the
                    # trace anchors; a legacy text-format scraper gets
                    # the 0.0.4 wire format untouched — one exemplar
                    # suffix would fail its entire scrape.
                    accept = self.headers.get("Accept", "")
                    if "application/openmetrics-text" in accept:
                        body = registry_ref.render(exemplars=True) \
                            + "# EOF\n"
                        self._reply(
                            body.encode(),
                            "application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")
                        return
                    self._reply(registry_ref.render().encode(),
                                "text/plain; version=0.0.4")
                    return
                if parsed.path == "/debug/spans":
                    # Complete Chrome-trace JSON of the span ring: save the
                    # body to a file and open it in Perfetto directly.
                    import json

                    from oim_tpu_torch.common import tracing

                    body = json.dumps(
                        {"traceEvents": tracing.recorder().to_events()})
                    self._reply(body.encode(), "application/json")
                    return
                if parsed.path == "/debug/events":
                    # The flight recorder, filterable: ?trace=<trace_id>
                    # answers "what happened to THIS request", ?type=
                    # narrows to one incident class, ?limit= bounds the
                    # reply to the newest n.
                    from oim_tpu_torch.common import events

                    query = urllib.parse.parse_qs(parsed.query)

                    def q(name: str) -> str:
                        vals = query.get(name)
                        return vals[-1] if vals else ""

                    try:
                        limit = int(q("limit") or 0)
                    except ValueError:
                        limit = 0
                    body = events.recorder().to_json(
                        trace_id=q("trace"), type_=q("type"), limit=limit)
                    self._reply(body.encode(), "application/json")
                    return
                self.send_error(404)

            def log_message(self, *args):  # silence per-request stderr lines
                pass

        self.host = host
        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class Timer:
    """Context manager feeding a gauge (seconds)."""

    def __init__(self, gauge: Gauge):
        self.gauge = gauge
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.monotonic() - self._t0
        self.gauge.set(self.elapsed)
        return False
