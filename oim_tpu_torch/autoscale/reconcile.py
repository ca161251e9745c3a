"""The autoscaler's decision core: a pure reconcile function plus the
leadership gate, both driven by explicit clocks so tests pin every
transition without a sleep.

``plan()`` is one reconcile step: (declared spec, observed replicas,
firing alerts, now, carried state) -> (actions, next state). It owns
the fleet-sizing policy —

* the target starts at ``min_replicas`` (scale-to-zero when that is 0)
  and steps UP one replica per cooldown while any ``alert/`` row fires
  with direction "up", never past ``max_replicas``;
* with no alert for ``scale_down_hold_s``, the target decays back DOWN
  one per cooldown, draining the worst-scoring replica each step;
* a rolling upgrade (``spec.version`` differs from what ready replicas
  advertise) surges one fresh-version spawn, then drains one stale
  replica once the fleet is whole again — capacity never drops below
  target mid-flip, and an upgrade pauses entirely while an alert fires;
* spawns that merely repair the fleet back to the current target (a
  died replica, first boot to min) bypass the cooldown: damping exists
  to stop flapping DECISIONS, not to slow recovery.

The caller contract that keeps ``plan()`` pure AND non-duplicating:
``observed`` must include launches still in flight (the daemon
synthesizes a not-ready row per pending spawn), so re-planning while a
replica boots never spawns it twice.

``LeaderGate`` is the fleet/ row's HA half (the registry's own lease-
as-leadership pattern): an autoscaler leads when the desired-state row
is absent, its own, or provably dead — meaning the row's monotonic
``beat`` has not PROGRESSED for ``stale_after_s``. Progress, not
presence: a watcher replaying the dead leader's frozen row (a RESET
resync, a stale cache) re-delivers an old beat, which never refreshes
the gate's clock — stale desired-state cannot be re-admitted as fresh.

Pure stdlib (no grpc, no jax): ``oimctl`` and tests import this
without touching the daemon stack.
"""

from __future__ import annotations

import dataclasses

NEVER = float("-inf")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The declared fleet: what the operator wants, versioned."""

    min_replicas: int = 1
    max_replicas: int = 1
    # Desired weights version; "" = unversioned (no upgrade pressure,
    # spawns advertise nothing). Setting it to a value some ready
    # replicas don't advertise starts a rolling upgrade wave.
    version: str = ""
    # Flap damping: minimum seconds between elastic DECISIONS (target
    # steps, drains, upgrade flips). Repair spawns are exempt.
    cooldown_s: float = 15.0
    # Alert-free seconds before the target starts decaying back toward
    # min_replicas — scale-down must be much lazier than scale-up.
    scale_down_hold_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class ObservedReplica:
    """One serve/ row (or pending launch) as the reconciler sees it."""

    replica_id: str
    ready: bool = True
    version: str = ""
    # The router's load score (queue_depth - free_slots): the drain
    # policy picks the WORST-scoring replica, mirroring the pick policy
    # picking the best.
    score: int = 0


@dataclasses.dataclass(frozen=True)
class Action:
    """One actuation the daemon executes through its ReplicaLauncher."""

    kind: str  # "spawn" | "drain"
    replica_id: str = ""  # drain target; spawns get their id from the launcher
    version: str = ""  # the weights version a spawn must boot with
    reason: str = ""  # "alert:<slo>" | "idle" | "repair" | "clamp" | "upgrade"


@dataclasses.dataclass(frozen=True)
class ReconcileState:
    """What one plan() step carries to the next."""

    target: int = -1  # -1 = unset: adopt spec.min_replicas on first plan
    last_action_at: float = NEVER
    clear_since: float | None = None  # when the alert/ prefix last emptied


def wants_scale_up(alert_body) -> bool:
    """Does this alert/ row ask for capacity? Missing or malformed
    ``direction`` means yes — rows from a pre-field monitor (and
    garbage) read as the conservative "add capacity", never as "shrink
    under an active alert" (mixed-version safe)."""
    if not isinstance(alert_body, dict):
        return True
    return alert_body.get("direction", "up") == "up"


def _drain_candidate(candidates, spec_version):
    """The replica a shrink (or upgrade flip) drains: stale-version
    rows first when a version is declared, worst router score within
    that, replica id as the deterministic tie-break."""
    if not candidates:
        return None
    return max(candidates,
               key=lambda o: (bool(spec_version) and o.version != spec_version,
                              o.score, o.replica_id))


def plan(
    spec: FleetSpec,
    observed: list[ObservedReplica],
    alerts: dict,
    now: float,
    state: ReconcileState,
) -> tuple[list[Action], ReconcileState]:
    """One pure reconcile step; see the module docstring for the
    policy. ``alerts`` maps alert name -> row body (dict) for every
    currently-firing ``alert/`` row."""
    prior = state.target if state.target >= 0 else spec.min_replicas
    target = max(spec.min_replicas, min(spec.max_replicas, prior))
    ready = [o for o in observed if o.ready]
    firing_up = sorted(n for n, b in alerts.items() if wants_scale_up(b))
    clear_since = None if alerts else (
        state.clear_since if state.clear_since is not None else now)
    cooled = now - state.last_action_at >= spec.cooldown_s

    reason = ""
    if firing_up and cooled and target < spec.max_replicas \
            and len(ready) >= target:
        # Step up only after the previous step LANDED (ready covers the
        # current target): one alert must grow the fleet one boot at a
        # time, not fork-bomb it while replicas are still coming up.
        target += 1
        reason = f"alert:{firing_up[0]}"
    elif not alerts and cooled and target > spec.min_replicas \
            and clear_since is not None \
            and now - clear_since >= spec.scale_down_hold_s:
        target -= 1
        reason = "idle"

    actions: list[Action] = []
    if len(observed) < target:
        actions.extend(
            Action("spawn", version=spec.version, reason=reason or "repair")
            for _ in range(target - len(observed)))
    elif len(observed) > target and cooled and len(ready) > target:
        # Shrink only out of READY surplus: draining while a boot is
        # still in flight would dip capacity below target.
        victim = _drain_candidate(ready, spec.version)
        if victim is not None:
            drain_reason = reason or (
                "upgrade" if spec.version and victim.version != spec.version
                else "clamp")
            actions.append(Action("drain", replica_id=victim.replica_id,
                                  reason=drain_reason))
    elif spec.version and not alerts and cooled \
            and len(observed) == target and len(ready) == target \
            and any(o.version != spec.version for o in ready):
        # Rolling upgrade: surge one fresh spawn; the next cooled step
        # sees the ready surplus and drains one stale replica (the
        # branch above, stale-preferred). At max capacity there is no
        # surge headroom, so flip drain-first instead.
        if target < spec.max_replicas:
            actions.append(
                Action("spawn", version=spec.version, reason="upgrade"))
        else:
            victim = _drain_candidate(
                [o for o in ready if o.version != spec.version],
                spec.version)
            actions.append(Action("drain", replica_id=victim.replica_id,
                                  reason="upgrade"))

    acted = target != prior or any(a.reason != "repair" for a in actions)
    return actions, ReconcileState(
        target=target,
        last_action_at=now if acted else state.last_action_at,
        clear_since=clear_since,
    )


class LeaderGate:
    """Should THIS autoscaler act, given the observed fleet/ row? See
    the module docstring; ``observe()`` is the whole API."""

    def __init__(self, me: str, stale_after_s: float):
        self.me = me
        self.stale_after_s = stale_after_s
        self._owner = None  # the foreign writer currently tracked
        self._beat = None  # its highest beat seen
        self._beat_at = NEVER  # when that beat first appeared
        self.leading = False

    def observe(self, row: dict | None, now: float) -> bool:
        """Feed the current fleet/ row (None = absent, deleted, or
        lease-expired) and the caller's clock; returns whether this
        autoscaler holds leadership. The row's writer keeps it only
        while its ``beat`` keeps progressing."""
        if row is None or not isinstance(row, dict):
            # No live claim (or an unreadable one — a row nobody can
            # parse must not fence the fleet): take over.
            self._owner, self._beat, self._beat_at = None, None, NEVER
            self.leading = True
            return True
        owner = row.get("autoscaler")
        if owner == self.me:
            self.leading = True
            return True
        beat = row.get("beat")
        beat = beat if isinstance(beat, (int, float)) else None
        if owner != self._owner:
            # A different autoscaler claimed the row: restart the
            # freshness clock for the new writer.
            self._owner, self._beat, self._beat_at = owner, beat, now
        elif beat is not None and (self._beat is None or beat > self._beat):
            # Progress — the one signal that refreshes freshness. An
            # equal or LOWER beat (a replayed frozen row) does not.
            self._beat, self._beat_at = beat, now
        self.leading = now - self._beat_at >= self.stale_after_s
        return self.leading
