"""SLO declarations + Google-SRE multi-window burn-rate evaluation.

An SLO declares an objective over a good/total event ratio; the engine
samples the FLEET-merged cumulative (good, total) pair on every
evaluation tick and computes the burn rate over two windows:

    burn(window) = bad_fraction(window) / error_budget
    bad_fraction = (d_total - d_good) / d_total   over the window
    error_budget = 1 - objective

The alert condition is the SRE-workbook multi-window AND: the FAST
window (default 5m) proves the problem is happening *now*, the SLOW
window (default 1h) proves it is sustained — a single slow request
cannot page, and a long-since-healed incident stops paging as soon as
the fast window slides clear. Burn-rate deltas are computed between the
newest sample and the latest sample at or before the window start
(falling back to the oldest retained sample while the series is still
shorter than the window — a monitor that just booted into an outage
must still fire).

``AlertEpisode`` debounces: one ``slo_alert_fired`` per episode however
often the burn rate flaps across the threshold, and resolution only
after the condition has been clear for a hysteresis hold (the
``page_pool_exhausted`` flight-recorder stance from PR 11, applied to
alerts).

Two SLO kinds ship:

* ``latency``     — good = observations at or under ``threshold_s`` in a
  merged histogram (``metric`` names the snapshot key in the telemetry
  row: ``first_token``, ``inter_token``, ``queue_wait``, ``rpc``).
  The threshold snaps down to a bucket bound (merge.good_count).
* ``availability`` — good = completions whose outcome is not in
  ``bad_outcomes``, from the merged ``requests_total`` counters.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable

from oim_tpu_torch.common import events
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.obs import merge

# Canonical histogram keys a telemetry row's "hist" field may carry
# (common/telemetry.py metrics_snapshot publishes these).
HIST_KEYS = ("first_token", "inter_token", "queue_wait", "rpc")

# SRE-workbook page-severity burn threshold for a 5m/1h window pair:
# burning a 30-day budget 14.4x faster exhausts it in ~2 days.
DEFAULT_BURN_THRESHOLD = 14.4


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective. ``name`` is the alert-row key."""

    name: str
    kind: str  # "latency" | "availability"
    objective: float  # e.g. 0.99 => 1% error budget
    metric: str = ""  # latency: the telemetry-row hist key
    threshold_s: float = 0.0  # latency: good <= threshold
    bad_outcomes: tuple = ("rejected", "error")

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if self.kind == "latency" and (
                not self.metric or self.threshold_s <= 0):
            raise ValueError(
                "latency SLO needs metric= and threshold_s > 0")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


def default_slos(first_token_p99_s: float = 0.25,
                 availability: float = 0.999) -> list[SLO]:
    """The monitor's stock SLO pair: first-token latency + availability
    (``oim-monitor`` flags re-parameterize these)."""
    return [
        SLO(name="first_token_p99", kind="latency", objective=0.99,
            metric="first_token", threshold_s=first_token_p99_s),
        SLO(name="availability", kind="availability",
            objective=availability),
    ]


class BurnSeries:
    """Cumulative (ts, good, total) samples + windowed burn rates."""

    def __init__(self, retain_s: float):
        self.retain_s = retain_s
        self._samples: collections.deque[tuple[float, int, int]] = (
            collections.deque())

    def sample(self, ts: float, good: int, total: int) -> None:
        """Record one cumulative observation pair. Values must be
        fleet-merged cumulatives (FleetHistogram/FleetCounter keep them
        monotone through replica restarts); a non-monotone sample is
        clamped rather than poisoning every later delta."""
        if self._samples:
            _, pg, pt = self._samples[-1]
            good, total = max(good, pg), max(total, pt)
        self._samples.append((ts, good, total))
        floor = ts - self.retain_s
        # Keep one sample AT or before the retention floor: it is the
        # slow window's baseline.
        while len(self._samples) >= 2 and self._samples[1][0] <= floor:
            self._samples.popleft()

    def delta(self, window_s: float, now: float) -> tuple[int, int]:
        """(d_good, d_total) between the newest sample and the window
        baseline (latest sample at or before ``now - window_s``, else
        the oldest retained)."""
        if not self._samples:
            return 0, 0
        start = now - window_s
        baseline = self._samples[0]
        for s in self._samples:
            if s[0] <= start:
                baseline = s
            else:
                break
        _, g1, t1 = self._samples[-1]
        _, g0, t0 = baseline
        return max(g1 - g0, 0), max(t1 - t0, 0)

    def burn(self, window_s: float, budget: float, now: float) -> float:
        """bad_fraction over the window divided by the error budget;
        0.0 with no traffic in the window (no evidence is not an
        outage — availability alerts need failures, not silence)."""
        d_good, d_total = self.delta(window_s, now)
        if d_total <= 0 or budget <= 0:
            return 0.0
        return ((d_total - d_good) / d_total) / budget


class AlertEpisode:
    """Per-SLO debounced firing state: one fired transition per episode,
    resolve only after ``resolve_hold_s`` continuously clear."""

    def __init__(self, resolve_hold_s: float):
        self.resolve_hold_s = resolve_hold_s
        self.firing = False
        self.since = 0.0  # unix ts the current episode fired
        self._clear_since: float | None = None

    def update(self, breaching: bool, now: float) -> str | None:
        """Advance the state machine; returns "fired" / "resolved" on a
        transition, None otherwise."""
        if breaching:
            self._clear_since = None
            if not self.firing:
                self.firing = True
                self.since = now
                return "fired"
            return None
        if not self.firing:
            return None
        if self._clear_since is None:
            self._clear_since = now
        if now - self._clear_since >= self.resolve_hold_s:
            self.firing = False
            self._clear_since = None
            return "resolved"
        return None


class SloEngine:
    """Fleet-merged telemetry in, burn rates + alert transitions out.

    ``ingest`` feeds one replica's telemetry-row body (its ``hist`` and
    ``counters`` fields); ``evaluate`` samples the merged cumulatives,
    computes both windows' burn rates, updates the ``oim_slo_*`` gauges,
    emits ``slo_alert_fired`` / ``slo_alert_resolved`` flight-recorder
    events, and returns the transitions for the caller (oim-monitor) to
    mirror into ``alert/<name>`` registry rows. Not thread-safe — the
    monitor serializes ingest/evaluate under its own lock."""

    def __init__(
        self,
        slos: Iterable[SLO] | None = None,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        resolve_hold_s: float = 120.0,
    ):
        self.slos = list(default_slos() if slos is None else slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than slow")
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self.hists: dict[str, merge.FleetHistogram] = {
            key: merge.FleetHistogram() for key in HIST_KEYS}
        self.counters = merge.FleetCounter()
        self._series = {s.name: BurnSeries(retain_s=slow_window_s * 1.5)
                        for s in self.slos}
        self._episodes = {s.name: AlertEpisode(resolve_hold_s)
                          for s in self.slos}
        self._burns: dict[str, tuple[float, float]] = {
            s.name: (0.0, 0.0) for s in self.slos}

    # -- ingest -----------------------------------------------------------

    def ingest(self, replica_id: str, row: dict) -> None:
        """Fold one ``telemetry/<id>`` row body into the fleet view.
        Rows without snapshots (pre-upgrade daemons) are a no-op — the
        mixed-version stance; malformed snapshots are skipped per key."""
        if not isinstance(row, dict):
            return
        hist = row.get("hist")
        if isinstance(hist, dict):
            for key, fleet in self.hists.items():
                snap = hist.get(key)
                if snap is not None:
                    try:
                        fleet.update(replica_id, snap)
                    except ValueError:
                        pass
        counters = row.get("counters")
        if isinstance(counters, dict):
            requests = counters.get("requests_total")
            if isinstance(requests, dict):
                self.counters.update(replica_id, requests)

    def forget(self, replica_id: str) -> None:
        """Close a replica's epoch (deliberate deregistration — NOT
        lease expiry, which just freezes the row in place). Its history
        is banked, not dropped: the merged cumulatives the burn windows
        difference must stay monotone, or a routine drain would zero
        the deltas and blind alerting until fresh traffic re-exceeded
        the dropped totals."""
        for fleet in self.hists.values():
            fleet.forget(replica_id)
        self.counters.forget(replica_id)

    # -- evaluation -------------------------------------------------------

    def _good_total(self, slo: SLO) -> tuple[int, int]:
        if slo.kind == "latency":
            merged = self.hists[slo.metric].merged() \
                if slo.metric in self.hists else None
            if merged is None:
                return 0, 0
            return (merge.good_count(merged, slo.threshold_s),
                    merge.total(merged))
        totals = self.counters.merged()
        grand = int(round(sum(totals.values())))
        bad = int(round(sum(totals.get(o, 0.0) for o in slo.bad_outcomes)))
        return max(grand - bad, 0), grand

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One tick: sample, burn, transition. Returns the transitions
        as dicts (slo/transition/burn_fast/burn_slow/since)."""
        if now is None:
            now = time.time()
        transitions = []
        firing = 0
        for slo in self.slos:
            series = self._series[slo.name]
            good, total = self._good_total(slo)
            series.sample(now, good, total)
            burn_fast = series.burn(self.fast_window_s, slo.budget, now)
            burn_slow = series.burn(self.slow_window_s, slo.budget, now)
            self._burns[slo.name] = (burn_fast, burn_slow)
            M.SLO_BURN_RATE.labels(slo=slo.name).set(burn_fast)
            breaching = (burn_fast >= self.burn_threshold
                         and burn_slow >= self.burn_threshold)
            transition = self._episodes[slo.name].update(breaching, now)
            if self._episodes[slo.name].firing:
                firing += 1
            if transition is not None:
                event_type = (events.SLO_ALERT_FIRED
                              if transition == "fired"
                              else events.SLO_ALERT_RESOLVED)
                events.emit(event_type, slo=slo.name,
                            burn_fast=round(burn_fast, 3),
                            burn_slow=round(burn_slow, 3),
                            threshold=self.burn_threshold)
                transitions.append({
                    "slo": slo.name,
                    "transition": transition,
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "since": self._episodes[slo.name].since,
                })
        M.SLO_ALERTS_FIRING.set(firing)
        return transitions

    # -- views ------------------------------------------------------------

    def status(self, slo_name: str) -> dict:
        """The alert-row body for one SLO (doc/architecture.md schema)."""
        slo = next(s for s in self.slos if s.name == slo_name)
        episode = self._episodes[slo_name]
        burn_fast, burn_slow = self._burns[slo_name]
        body = {
            "slo": slo.name,
            "kind": slo.kind,
            "objective": slo.objective,
            "state": "firing" if episode.firing else "ok",
            "burn_fast": round(burn_fast, 4),
            "burn_slow": round(burn_slow, 4),
            "threshold": self.burn_threshold,
            "windows_s": [self.fast_window_s, self.slow_window_s],
        }
        if slo.kind == "latency":
            body["metric"] = slo.metric
            body["threshold_s"] = slo.threshold_s
        if episode.firing:
            body["since"] = round(episode.since, 3)
            # The actuator-facing hint: "up" while the burn rate still
            # breaches (add capacity), "down" once the episode is inside
            # its resolve-hysteresis hold (the breach cleared; the alert
            # only persists so a flap can't silence it early). Readers
            # that predate the field treat a bare firing row as "up" —
            # and writers that predate it omit it, so consumers default
            # the same way (mixed-version safe in both directions).
            body["direction"] = ("up" if burn_fast >= self.burn_threshold
                                 else "down")
        return body

    def firing(self) -> list[str]:
        return [name for name, ep in self._episodes.items() if ep.firing]

    def fleet_quantiles(self, metric: str,
                        qs=(0.5, 0.99)) -> list[float] | None:
        """Merged fleet quantiles for one histogram key, or None when no
        replica has published a snapshot for it (the --top dash)."""
        fleet = self.hists.get(metric)
        merged = fleet.merged() if fleet is not None else None
        if merged is None or merge.total(merged) == 0:
            return None
        return [merge.quantile(merged, q) for q in qs]
