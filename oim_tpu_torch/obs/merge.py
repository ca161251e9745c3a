"""Mergeable histogram snapshots: the algebra under the fleet SLO plane.

A snapshot is the wire form of one histogram at one instant, as carried
inside a daemon's TTL-leased ``telemetry/<id>`` row heartbeat:

    {"le": [0.005, ..., 10.0],       # shared bucket upper bounds
     "counts": [c1, ..., cn, total], # CUMULATIVE; last entry = +Inf
     "sum": 12.34}                    # sum of observations

``len(counts) == len(le) + 1``; counts are cumulative (Prometheus
``_bucket`` semantics), so ``counts[-1]`` is the observation count.

The algebra is deliberately tiny and total:

* ``zero(le)`` is the identity: ``add(zero, s) == s``.
* ``add`` is element-wise and therefore associative and commutative —
  merging a fleet is order-independent, which the tests pin.
* ``quantile`` is the PromQL ``histogram_quantile`` linear-interpolation
  estimate, shared with ``oimctl``'s scrape-side math so the CLI and the
  merge plane can never disagree about what a p99 is.

``FleetHistogram`` folds N replicas' *cumulative* snapshots into one
fleet histogram with counter-reset detection: a restarted replica
republishes from zero, so a snapshot whose total (or sum, or any
cumulative bucket) went DOWN starts a new epoch — the previous epoch's
final snapshot is banked into a base and the fresh one counts on top,
never producing a negative delta. A replica whose lease lapses keeps
its last contribution frozen in the merge (its history still happened);
only an explicit ``forget`` drops it.

Folding is INCREMENTAL: ``SnapshotFold`` keeps per-grid running
aggregates that contributors patch in and out on row change, so
``merged()`` is O(grids) per render instead of O(replicas) — at 1k
telemetry rows the from-scratch fold was the ``--top --watch`` render
knee (bench.py --control-plane records the paired before/after; the
``oim_top_merge_seconds{mode}`` histogram times both paths).
"""

from __future__ import annotations

import math
import time
from typing import Iterable, Sequence

from oim_tpu_torch.common import metrics as M

# Sum comparisons tolerate float re-serialization jitter; a genuine
# reset drops the sum by whole observations, not by rounding noise.
_SUM_EPS = 1e-9


def zero(le: Sequence[float]) -> dict:
    """The identity snapshot on the ``le`` grid."""
    return {"le": list(le), "counts": [0] * (len(le) + 1), "sum": 0.0}


def validate(snap: object) -> tuple[tuple[float, ...], tuple[int, ...], float]:
    """(le, cumulative counts, sum) from a wire snapshot, or ValueError.

    Tolerant of JSON round-trips (lists of int/float) but strict about
    shape and monotonicity: a malformed row from one replica must be
    skippable, never silently merged into a wrong fleet percentile."""
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot must be a dict, got {type(snap).__name__}")
    le = snap.get("le")
    counts = snap.get("counts")
    total_sum = snap.get("sum", 0.0)
    if not isinstance(le, (list, tuple)) or not isinstance(counts, (list, tuple)):
        raise ValueError("snapshot needs 'le' and 'counts' lists")
    if len(counts) != len(le) + 1:
        raise ValueError(
            f"counts must have len(le)+1 entries (+Inf last), got "
            f"{len(counts)} for {len(le)} bounds")
    bounds = tuple(float(b) for b in le)
    if any(b != b or b == float("inf") for b in bounds):
        raise ValueError("bucket bounds must be finite")
    if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
        raise ValueError(f"bucket bounds must be strictly increasing: {bounds}")
    vals = []
    prev = 0
    for c in counts:
        if isinstance(c, bool) or not isinstance(c, (int, float)) \
                or c != int(c) or c < 0:
            raise ValueError(f"counts must be non-negative integers: {counts}")
        c = int(c)
        if c < prev:
            raise ValueError(f"cumulative counts must be monotone: {counts}")
        vals.append(c)
        prev = c
    if not isinstance(total_sum, (int, float)) or total_sum != total_sum:
        raise ValueError(f"sum must be a number, got {total_sum!r}")
    return bounds, tuple(vals), float(total_sum)


def add(a: dict, b: dict) -> dict:
    """Element-wise merge of two snapshots on the SAME ``le`` grid."""
    le_a, counts_a, sum_a = validate(a)
    le_b, counts_b, sum_b = validate(b)
    if le_a != le_b:
        raise ValueError(
            f"cannot merge snapshots on different bucket grids: "
            f"{le_a} vs {le_b}")
    return {"le": list(le_a),
            "counts": [x + y for x, y in zip(counts_a, counts_b)],
            "sum": sum_a + sum_b}


def total(snap: dict) -> int:
    """Observation count of a snapshot (the +Inf cumulative entry)."""
    _, counts, _ = validate(snap)
    return counts[-1]


def bucket_quantile(buckets: list[tuple[float, float]], q: float) -> float:
    """Linear interpolation over cumulative (le, count) pairs — the
    PromQL histogram_quantile estimate. The ONE copy of this math:
    ``oimctl``'s scrape summaries and the fleet merge both call it."""
    if not buckets:
        return float("nan")
    grand = buckets[-1][1]
    if grand <= 0:
        return float("nan")
    rank = q * grand
    prev_bound, prev_count = 0.0, 0.0
    for bound, count in buckets:
        if count >= rank:
            if bound == float("inf"):
                return prev_bound
            span = count - prev_count
            frac = (rank - prev_count) / span if span else 1.0
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_count = bound, count
    return prev_bound


def quantile(snap: dict, q: float) -> float:
    """The q-quantile estimate of a snapshot (NaN when empty)."""
    le, counts, _ = validate(snap)
    pairs = list(zip(le, counts)) + [(float("inf"), counts[-1])]
    return bucket_quantile(pairs, q)


def bucket_index(snap: dict, value: float) -> int:
    """Index of the bucket ``value`` lands in (len(le) = +Inf). The
    "within one bucket" acceptance comparisons live at this resolution —
    a bucketed histogram cannot promise finer."""
    le, _, _ = validate(snap)
    for i, bound in enumerate(le):
        if value <= bound:
            return i
    return len(le)


def good_count(snap: dict, threshold: float) -> int:
    """Observations at or under ``threshold`` — the latency-SLO "good"
    numerator. The threshold snaps DOWN to the nearest bucket bound
    (the histogram cannot resolve finer; snapping down is the
    conservative direction — it never counts a slow request as good)."""
    le, counts, _ = validate(snap)
    good = 0
    for bound, count in zip(le, counts):
        if bound <= threshold + _SUM_EPS:
            good = count
        else:
            break
    return good


def is_reset(prev: dict, cur: dict) -> bool:
    """True when ``cur`` cannot be a continuation of ``prev``: the
    publisher restarted (total, sum, or any cumulative bucket went
    down). Equal counts with a lower sum is still a reset — a restarted
    replica can coincidentally re-reach the same count."""
    le_p, counts_p, sum_p = validate(prev)
    le_c, counts_c, sum_c = validate(cur)
    if le_p != le_c:
        return True
    if any(c < p for p, c in zip(counts_p, counts_c)):
        return True
    return sum_c < sum_p - max(_SUM_EPS, abs(sum_p) * 1e-9)


class SnapshotFold:
    """Incremental ``merge_snapshots``: contributors register snapshots
    under a key; per-grid running aggregates make ``merged()`` O(grids)
    instead of O(contributors), and ``set``/``drop`` cost O(buckets).
    For any sequence of set/drop calls, ``merged()`` equals
    ``merge_snapshots`` over the surviving contributions (bucket counts
    exactly — they are integer sums; the observation sum to float
    patch-out jitter), which tests/test_obs_merge.py pins
    property-style."""

    def __init__(self) -> None:
        self._snaps: dict[object, dict] = {}
        # grid -> {"counts": running cumulative sums, "sum": float,
        #          "n": contributor count} — dropped when n reaches 0.
        self._agg: dict[tuple[float, ...], dict] = {}

    def _patch_out(self, key: object) -> None:
        old = self._snaps.pop(key, None)
        if old is None:
            return
        grid = tuple(old["le"])
        agg = self._agg[grid]
        agg["n"] -= 1
        if agg["n"] == 0:
            del self._agg[grid]
            return
        counts = agg["counts"]
        for i, c in enumerate(old["counts"]):
            counts[i] -= c
        agg["sum"] -= old["sum"]

    def set(self, key: object, snap: dict | None) -> None:
        """Register/replace one contributor. ``None`` (or a snapshot
        ``validate`` rejects) drops it — the same skip-don't-poison
        stance ``merge_snapshots`` takes on malformed rows."""
        self._patch_out(key)
        if snap is None:
            return
        try:
            le, counts, total_sum = validate(snap)
        except ValueError:
            return
        self._snaps[key] = {"le": list(le), "counts": list(counts),
                            "sum": total_sum}
        agg = self._agg.get(le)
        if agg is None:
            self._agg[le] = {"counts": list(counts), "sum": total_sum,
                             "n": 1}
        else:
            running = agg["counts"]
            for i, c in enumerate(counts):
                running[i] += c
            agg["sum"] += total_sum
            agg["n"] += 1

    def drop(self, key: object) -> None:
        self._patch_out(key)

    def keys(self) -> list:
        return list(self._snaps)

    def merged(self) -> dict | None:
        """The majority-grid aggregate (same grid election as
        ``merge_snapshots``), or None with no contributors."""
        t0 = time.monotonic()
        if not self._agg:
            return None
        grid = max(self._agg,
                   key=lambda g: (self._agg[g]["n"],
                                  self._agg[g]["counts"][-1], g))
        agg = self._agg[grid]
        out = {"le": list(grid), "counts": list(agg["counts"]),
               "sum": agg["sum"]}
        M.TOP_MERGE_SECONDS.labels(mode="incremental").observe(
            time.monotonic() - t0)
        return out


class FleetHistogram:
    """Counter-reset-aware fold of per-replica cumulative snapshots.

    ``update(replica, snap)`` ingests one heartbeat's snapshot;
    ``merged()`` returns the fleet histogram (base epochs + live
    snapshots + departed replicas' closed epochs, summed). Replicas
    publishing a different ``le`` grid than the fleet majority are
    excluded from ``merged()`` (the mixed-version dash stance) but keep
    their own history. A ``SnapshotFold`` mirrors every contribution so
    ``merged()`` costs O(grids) however often it renders; the
    from-scratch oracle survives as ``merged_scratch()``."""

    def __init__(self) -> None:
        self._last: dict[str, dict] = {}
        self._base: dict[str, dict] = {}
        # Closed epochs of replicas that deregistered, folded per grid:
        # departed history must KEEP counting in merged() — dropping it
        # would deflate the fleet cumulative, and the SLO plane's burn
        # windows (which clamp non-monotone feeds) would then read zero
        # deltas until fresh traffic re-exceeded the forgotten totals,
        # blinding alerting for hours after a rolling restart.
        self._departed: dict[tuple[float, ...], dict] = {}
        # Incremental mirror: ("live", rid) carries replica(rid),
        # ("departed", grid) carries that grid's departed bank.
        self._fold = SnapshotFold()

    def update(self, replica_id: str, snap: dict) -> None:
        le, counts, total_sum = validate(snap)
        clean = {"le": list(le), "counts": list(counts), "sum": total_sum}
        last = self._last.get(replica_id)
        if last is not None and is_reset(last, clean):
            if tuple(last["le"]) == le:
                base = self._base.get(replica_id) or zero(le)
                self._base[replica_id] = add(base, last)
            else:
                # Grid changed (upgrade/rebucket): the old epoch cannot
                # fold onto the new grid — its history is dropped rather
                # than mis-bucketed.
                self._base.pop(replica_id, None)
        self._last[replica_id] = clean
        self._fold.set(("live", replica_id), self.replica(replica_id))

    def forget(self, replica_id: str) -> None:
        """Close a replica's epoch (explicit deregistration): its id
        stops updating and frees its per-replica state, but its folded
        history is banked into the departed accumulator — fleet
        cumulatives stay MONOTONE, which the burn-rate series depends
        on. (Lease expiry doesn't even reach here: an expired row just
        freezes in place.) A re-registering id starts a fresh epoch."""
        folded = self.replica(replica_id)
        if folded is not None:
            grid = tuple(folded["le"])
            bank = self._departed.get(grid)
            self._departed[grid] = folded if bank is None \
                else add(bank, folded)
            self._fold.set(("departed", grid), self._departed[grid])
        self._last.pop(replica_id, None)
        self._base.pop(replica_id, None)
        self._fold.drop(("live", replica_id))

    def replica(self, replica_id: str) -> dict | None:
        """One replica's epoch-folded histogram (base + live)."""
        last = self._last.get(replica_id)
        if last is None:
            return None
        base = self._base.get(replica_id)
        return add(base, last) if base is not None else dict(last)

    def replicas(self) -> list[str]:
        return sorted(self._last)

    def merged(self) -> dict | None:
        """The fleet histogram (live replicas + departed epochs), or
        None when nothing has ever published. Served from the
        incremental fold: O(grids), however many replicas contribute."""
        return self._fold.merged()

    def merged_scratch(self) -> dict | None:
        """The from-scratch reference fold — re-merges every
        contributor per call, O(replicas). Kept as the equivalence
        oracle ``merged()`` is tested against and as the baseline side
        of the bench's paired incremental-vs-scratch comparison."""
        folded = [self.replica(rid) for rid in self._last]
        folded.extend(self._departed.values())
        return merge_snapshots(folded)


def merge_snapshots(snaps: Iterable[dict | None]) -> dict | None:
    """Merge snapshots that share the majority ``le`` grid; None/invalid
    entries and minority-grid snapshots are skipped (ties break toward
    the grid holding more observations, then the larger grid — a total
    order, so the incremental fold elects identically). None when
    nothing merges."""
    t0 = time.monotonic()
    by_grid: dict[tuple[float, ...], list[dict]] = {}
    for snap in snaps:
        if snap is None:
            continue
        try:
            le, counts, total_sum = validate(snap)
        except ValueError:
            continue
        by_grid.setdefault(le, []).append(
            {"le": list(le), "counts": list(counts), "sum": total_sum})
    if not by_grid:
        return None
    grid = max(by_grid,
               key=lambda g: (len(by_grid[g]),
                              sum(s["counts"][-1] for s in by_grid[g]), g))
    out = zero(grid)
    for snap in by_grid[grid]:
        out = add(out, snap)
    M.TOP_MERGE_SECONDS.labels(mode="scratch").observe(
        time.monotonic() - t0)
    return out


class FleetCounter:
    """Counter-reset-aware fold of per-replica labeled counter values
    (the availability SLO's ``requests_total{outcome}`` source): each
    replica publishes ``{label: cumulative}``; a decrease in any label
    banks the previous values as a new epoch base."""

    def __init__(self) -> None:
        self._last: dict[str, dict[str, float]] = {}
        self._base: dict[str, dict[str, float]] = {}
        # Departed replicas' closed epochs — banked for the same
        # monotone-cumulative reason as FleetHistogram._departed.
        self._departed: dict[str, float] = {}

    @staticmethod
    def _clean(values: dict) -> dict[str, float]:
        out = {}
        for k, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and v == v and v >= 0 and not math.isinf(v):
                out[str(k)] = float(v)
        return out

    def update(self, replica_id: str, values: dict) -> None:
        clean = self._clean(values)
        last = self._last.get(replica_id)
        if last is not None and any(
                clean.get(k, 0.0) < v - _SUM_EPS for k, v in last.items()):
            base = self._base.setdefault(replica_id, {})
            for k, v in last.items():
                base[k] = base.get(k, 0.0) + v
        self._last[replica_id] = clean

    def forget(self, replica_id: str) -> None:
        """Close the replica's epoch into the departed bank (see
        FleetHistogram.forget — merged totals must stay monotone)."""
        for source in (self._base.pop(replica_id, {}),
                       self._last.pop(replica_id, {})):
            for k, v in source.items():
                self._departed[k] = self._departed.get(k, 0.0) + v

    def merged(self) -> dict[str, float]:
        out = dict(self._departed)
        for rid, last in self._last.items():
            for source in (self._base.get(rid, {}), last):
                for k, v in source.items():
                    out[k] = out.get(k, 0.0) + v
        return out
