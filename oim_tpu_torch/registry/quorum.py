"""Raft-style quorum replication: a registry control plane that
survives partitions without a human.

The PR 2 pair (registry/replication.py) made the registry survivable,
but its partition story is a judgment call: the standby's watchdog
cannot tell "primary died" from "link died", so operators choose
between auto-promotion (split-brain risk under partition) and
``--primary-lease-seconds 0`` + a manual ``oimctl --promote``. This
module grows the same journal machinery — logical records, snapshot +
tail resync, epochs — into a 3+ member quorum where both failure modes
converge without intervention:

* **Terms and elections.** Promotion epochs become raft terms. A
  follower that hears no leader within its randomized election timeout
  campaigns: term+1, a vote for itself, ``Vote`` RPCs to every peer. A
  member votes at most once per term and only for a candidate whose
  log is at least as up-to-date as its own; a majority of grants makes
  a leader. Dueling candidates split the vote, re-draw their timeouts,
  and retry — the standard raft liveness argument.
* **Quorum-acknowledged commit.** A write is a journal proposal: the
  leader appends the record, streams it to followers over the existing
  ``Replicate`` pull stream, and acknowledges the client only once a
  majority of members hold it (followers report held offsets via the
  ``Ack`` RPC; the leader advances the commit offset to the highest
  offset a majority holds). State mutates — and becomes visible to
  ``GetValues`` and ``Watch`` — only at commit, on every member. A
  leader partitioned from the majority therefore CANNOT acknowledge or
  expose a write: split-brain is impossible by construction, not by
  timeout tuning.
* **Leader step-down.** Ack traffic doubles as majority-contact
  evidence. A leader that has not heard from a majority within the
  election timeout steps down to follower and fails its in-flight
  proposals ``UNAVAILABLE`` — the minority side of a symmetric
  partition demotes itself while the majority side elects.
* **Logs are per-leader.** Each elected leader starts a fresh journal
  (new ``log_id``, offsets from 0) whose every record belongs to its
  term; followers that carried another log resync by snapshot of the
  leader's COMMITTED state with tailing resumed at the commit offset.
  On winning an election the new leader first applies its buffered
  uncommitted tail — any record the old leader committed was, by the
  vote rule, received by the winner (majorities intersect), and a
  record the old leader never committed was never acknowledged to a
  client, so applying it is the usual idempotent-retry semantics. The
  one documented gap: the up-to-date comparison falls back to
  terms alone when two members followed different journal incarnations
  of the same term (unreachable under fail-stop kills + partitions,
  which re-elect before re-appending).

2-node deployments keep ``ReplicationManager`` (a 2-member "quorum"
would need both members for every write — no availability win);
``--quorum`` with 3+ members selects this manager.
"""

from __future__ import annotations

import json
import os
import threading
import time

import grpc

from oim_tpu_torch.common import backoff, events, faultinject, tracing
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.channelpool import ChannelPool
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.registry.db import get_registry_entries
from oim_tpu_torch.registry.replication import (
    KIND_HEARTBEAT,
    KIND_HELLO,
    KIND_KV,
    KIND_RENEW,
    KIND_SNAPSHOT_BEGIN,
    KIND_SNAPSHOT_END,
    ReplicationLog,
    _StaleEpoch,
)
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub

LEADER = "LEADER"
FOLLOWER = "FOLLOWER"
CANDIDATE = "CANDIDATE"


class NotLeader(Exception):
    """This member cannot accept the proposal; ``hint`` names the
    leader's address when known ("" otherwise)."""

    def __init__(self, hint: str = ""):
        super().__init__(f"not the leader (leader={hint or 'unknown'})")
        self.hint = hint


class QuorumUnavailable(Exception):
    """The proposal could not reach a majority (partitioned leader,
    mid-flight step-down, shutdown). The write was never acknowledged
    or made visible anywhere."""


def _position_ahead(reply, request) -> bool:
    """True when a vote reply advertises a log position STRICTLY ahead
    of the soliciting candidate's (VoteRequest) position — the same
    term-first, offsets-only-within-one-journal comparison the vote
    rule uses (same term + different log_id compares equal)."""
    if reply.last_log_term != request.last_log_term:
        return reply.last_log_term > request.last_log_term
    if reply.log_id == request.log_id:
        return reply.last_log_offset > request.last_log_offset
    return False


class _Partitioned(Exception):
    """Test-only partition lever tripped (see ``set_unreachable``)."""


class QuorumManager:
    """One member of a 3+ node raft-style registry quorum. Attaches
    itself to the ``RegistryService`` it is constructed with
    (``service.replication = self``); the service routes writes through
    :meth:`propose_kv` / :meth:`propose_renews` and serves the
    ``Replicate`` / ``Vote`` / ``Ack`` RPCs from here."""

    quorum = True

    def __init__(
        self,
        service,
        node_id: str,
        peers: list[str],
        election_timeout_s: float = 1.0,
        commit_timeout_s: float = 5.0,
        stepdown_grace_s: float = 0.0,
        state_file: str = "",
    ):
        self.service = service
        self.db = service.db
        self.leases = service.leases
        self.tls = service.tls
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.cluster_size = len(self.peers) + 1
        self.majority = self.cluster_size // 2 + 1
        self.election_timeout_s = election_timeout_s
        self.commit_timeout_s = commit_timeout_s
        # How long a leader tolerates majority silence before stepping
        # down. Default 2x the election timeout: longer than any single
        # missed ack cadence, shorter than operator patience. The chaos
        # ladder stretches it past the election window so a partition
        # rung's heal signature (majority elects, THEN the minority
        # leader steps down) is deterministic.
        self.stepdown_grace_s = stepdown_grace_s or 2 * election_timeout_s
        self.state_file = state_file

        self.role = FOLLOWER
        self.term = 0
        self.voted_for = ""
        self.log = ReplicationLog()
        self.log_term = 0  # the term this member's journal was created under
        self.commit_offset = 0  # offsets below this are committed AND applied
        # Leader state: per-peer highest held offset + last contact.
        self._match: dict[str, int] = {}
        self._contact: dict[str, float] = {}
        # Follower state: where the leader is and how fresh it is.
        self._leader_addr = ""
        self._last_contact = time.monotonic()
        self._election_deadline = self._draw_deadline()
        # Follower log position: highest contiguous offset held of the
        # leader's journal, the journal's id and term, and the buffered
        # uncommitted tail (applied as the advertised commit advances).
        self._received = 0
        self._received_log_id = ""
        self._received_term = 0
        self._leader_commit = 0
        self._pending: list = []
        self._in_snapshot = False
        self._snapshot_seen: set[str] = set()
        # The in-flight stream's journal identity: committed to
        # (_received_log_id, _received) only at SNAPSHOT_END or while
        # tailing — the legacy consistency discipline.
        self._stream_log_id = ""
        self._stream_term = 0

        # self._lock guards all of the above; _cond shares it so commit
        # waiters serialize with state transitions. _apply_lock
        # serializes appliers (commit advance); never hold _lock while
        # taking it.
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._apply_lock = threading.Lock()
        self._uncommitted: dict[int, object] = {}
        # Commit-pipeline timing: offset -> (append monotonic, trace id
        # of the proposing RPC), popped when the record commits so
        # oim_registry_commit_seconds can split ack/apply phases and
        # anchor exemplars. Cleared wherever _uncommitted is.
        self._append_meta: dict[int, tuple[float, str]] = {}
        # Campaign start (monotonic) while an election this member
        # opened is in flight: oim_registry_election_seconds observes
        # it at _become_leader (won elections only).
        self._campaign_t0 = 0.0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._call = None  # in-flight follower stream, cancellable
        self._threads: list[threading.Thread] = []
        self._pool = ChannelPool()
        # Test-only partition lever: member ids this node must behave
        # partitioned from, in BOTH directions.
        self._unreachable: set[str] = set()

        self._load_state()
        M.REGISTRY_ROLE.set(0.0)
        M.REGISTRY_TERM.set(float(self.term))
        M.REGISTRY_COMMIT_INDEX.set(0.0)
        service.replication = self

    # -- persistence -------------------------------------------------------

    def _load_state(self) -> None:
        if not self.state_file or not os.path.exists(self.state_file):
            return
        try:
            with open(self.state_file, encoding="utf-8") as f:
                doc = json.load(f)
            self.term = int(doc.get("term", 0))
            self.voted_for = str(doc.get("voted_for", ""))
        except (ValueError, OSError):
            pass  # corrupt sidecar: term 0, elections re-sync it

    def _save_state(self) -> None:
        if not self.state_file:
            return
        tmp = f"{self.state_file}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for,
                       "role": self.role}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_file)

    # -- small helpers -----------------------------------------------------

    @property
    def epoch(self) -> int:
        """Terms ARE the promotion epochs (service error messages,
        oimctl health rows)."""
        return self.term

    @property
    def is_primary(self) -> bool:
        return self.role == LEADER

    def leader_hint(self) -> str:
        with self._lock:
            return self.node_id if self.role == LEADER else self._leader_addr

    def _draw_deadline(self) -> float:
        # Randomized [T, 2T) — through the shared jitter source so a
        # seeded chaos ladder controls election timing too.
        return time.monotonic() + backoff.jittered(
            self.election_timeout_s, 1.0, 2.0)

    def _beat(self) -> float:
        return max(self.election_timeout_s / 3.0, 0.05)

    def set_unreachable(self, node_ids) -> None:
        """Partition lever (chaos sim): behave as if this member cannot
        exchange traffic with ``node_ids`` in either direction. Severs
        any in-flight follow of a now-unreachable leader."""
        with self._lock:
            self._unreachable = set(node_ids)
            sever = self._leader_addr in self._unreachable
        if sever:
            call, self._call = self._call, None
            if call is not None:
                call.cancel()
        self._wake.set()

    def _check_reachable(self, node_id: str) -> None:
        if node_id and node_id in self._unreachable:
            raise _Partitioned(node_id)

    def _peer_channel(self, target: str) -> grpc.Channel:
        return self._pool.get(target, self.tls, "component.registry")

    # -- proposals (the service's write path) ------------------------------

    def propose_kv(self, path: str, value: str,
                   lease_seconds: float) -> None:
        rec = pb.ReplicateRecord(
            kind=KIND_KV,
            value=pb.Value(path=path, value=value,
                           lease_seconds=lease_seconds))
        self._wait_commit(*self._append_record(rec))

    def propose_renews(self, prefixes: list[str], ttl: float) -> None:
        position = None
        for prefix in prefixes:
            position = self._append_record(pb.ReplicateRecord(
                kind=KIND_RENEW, renew_prefix=prefix, renew_ttl=ttl))
        if position is not None:
            self._wait_commit(*position)

    def record_kv(self, path: str, value: str, lease_seconds: float) -> None:
        """Fire-and-forget journal append (the registry's own telemetry
        row, written straight into the DB): replicated to followers,
        re-applied idempotently at commit."""
        if self.role == LEADER:
            self._append_record(pb.ReplicateRecord(
                kind=KIND_KV,
                value=pb.Value(path=path, value=value,
                               lease_seconds=lease_seconds)))

    def record_renew(self, prefix: str, ttl: float) -> None:
        if self.role == LEADER:
            self._append_record(pb.ReplicateRecord(
                kind=KIND_RENEW, renew_prefix=prefix, renew_ttl=ttl))

    def _append_record(self, rec) -> tuple[int, str]:
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self._leader_addr)
            self.log._append(rec)
            self._uncommitted[rec.offset] = rec
            self._append_meta[rec.offset] = (
                time.monotonic(), tracing.trace_id())
            position = (rec.offset, self.log.log_id)
        # A single-member "quorum" (and the leader's own vote toward
        # majority) may already satisfy commitment.
        self._maybe_advance_commit()
        return position

    def _wait_commit(self, offset: int, log_id: str) -> None:
        deadline = time.monotonic() + self.commit_timeout_s
        with self._cond:
            while True:
                if self.log.log_id == log_id \
                        and self.commit_offset > offset:
                    return
                if self._stop.is_set():
                    raise QuorumUnavailable("registry stopping")
                if self.role != LEADER or self.log.log_id != log_id:
                    # Stepped down (or superseded) with the record
                    # uncommitted: it was never acknowledged anywhere.
                    raise QuorumUnavailable(
                        f"leadership lost before offset {offset} "
                        f"committed (term {self.term})")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise QuorumUnavailable(
                        f"no quorum within {self.commit_timeout_s}s "
                        f"(majority {self.majority} of "
                        f"{self.cluster_size} unreachable)")
                self._cond.wait(remaining)

    def _maybe_advance_commit(self) -> None:
        """Advance the commit offset to the highest offset a majority
        holds, applying the newly committed records in order."""
        with self._apply_lock:
            with self._lock:
                if self.role != LEADER:
                    return
                held = sorted(
                    [self.log.next_offset]
                    + [self._match.get(p, 0) for p in self.peers],
                    reverse=True)
                target = held[self.majority - 1]
                if target <= self.commit_offset:
                    return
                recs = [self._uncommitted.pop(o)
                        for o in range(self.commit_offset, target)
                        if o in self._uncommitted]
                meta = [self._append_meta.pop(rec.offset, None)
                        for rec in recs]
            # Apply OUTSIDE self._lock (apply_kv fans out to Watch
            # streams) and WITHOUT the service write lock: in quorum
            # mode every client write funnels through propose (this is
            # the only applier, serialized by _apply_lock), and the one
            # direct-DB writer (the registry's own telemetry row) is
            # idempotent against its own journaled copy landing here.
            acked = time.monotonic()
            for rec in recs:
                self._apply_record(rec)
            applied = time.monotonic()
            for m in meta:
                if m is None:
                    continue  # appended by a previous leader's tenure
                t0, trace = m
                commit = M.REGISTRY_COMMIT_SECONDS
                commit.labels(phase="ack").observe(acked - t0, trace)
                commit.labels(phase="apply").observe(applied - acked, trace)
                commit.labels(phase="total").observe(applied - t0, trace)
            with self._cond:
                self.commit_offset = target
                M.REGISTRY_COMMIT_INDEX.set(float(target))
                self._cond.notify_all()

    def _apply_record(self, rec) -> None:
        if rec.kind == KIND_KV:
            self.service.apply_kv(rec.value.path, rec.value.value,
                                  rec.value.lease_seconds)
        elif rec.kind == KIND_RENEW:
            self.service.apply_renew(rec.renew_prefix, rec.renew_ttl)
        M.REPL_RECORDS_APPLIED.inc()

    # -- terms and roles ---------------------------------------------------

    def _adopt_term(self, term: int, reason: str) -> None:
        """Caller holds ``self._lock``. Adopt a higher term observed
        anywhere; a leader demotes."""
        if term <= self.term:
            return
        was_leader = self.role == LEADER
        self.term = term
        self.voted_for = ""
        self.role = FOLLOWER
        self._save_state()
        M.REGISTRY_TERM.set(float(self.term))
        self._election_deadline = self._draw_deadline()
        self._uncommitted.clear()
        self._append_meta.clear()
        self._cond.notify_all()  # fail in-flight proposals
        if was_leader:
            M.REGISTRY_ROLE.set(0.0)
            events.emit(events.REGISTRY_DEMOTION, epoch=term,
                        reason=reason)
            from_context().warning("demoted to FOLLOWER", term=term,
                                   reason=reason)

    def _step_down(self, reason: str) -> None:
        """A leader that lost majority contact demotes itself WITHOUT a
        successor: same term, writes refused, in-flight proposals
        failed — the minority half of partition safety."""
        with self._lock:
            if self.role != LEADER:
                return
            self.role = FOLLOWER
            self._leader_addr = ""
            self._uncommitted.clear()
            self._append_meta.clear()
            self._election_deadline = self._draw_deadline()
            self._cond.notify_all()
            term = self.term
        M.REGISTRY_ROLE.set(0.0)
        events.emit(events.REGISTRY_STEPDOWN, epoch=term, reason=reason)
        from_context().warning("stepped down: no majority contact",
                               term=term, reason=reason)
        self._wake.set()

    def promote(self, reason: str = "") -> bool:
        """Admin-forced election (``oimctl --promote`` / the
        ``registry/promote`` key): campaign NOW instead of waiting out
        an election timeout, skipping the pre-vote (operator intent
        overrides leader stickiness). Returns False when already
        leader."""
        if self.role == LEADER:
            return False
        self._campaign(reason=reason or "admin", force=True)
        return self.role == LEADER

    def _gather_votes(self, request,
                      vote_timeout: float) -> tuple[int, bool]:
        """Solicit every peer in parallel; returns (grants, ahead) —
        grants includes the self vote, ahead is True when any reply
        (granted or not) advertised a log position strictly ahead of
        the candidate's. Higher terms in replies are adopted."""
        grants = [1]
        ahead = [False]
        finished = [0]
        vote_lock = threading.Lock()
        done = threading.Event()

        def solicit(target: str) -> None:
            # Every solicitation resolves (reply, error, or the RPC
            # deadline) — `done` fires only when ALL have, never on a
            # majority short-circuit: the ahead-position evidence this
            # round exists to collect may be a DENY from the slowest
            # live peer, and returning early would elect without it.
            try:
                try:
                    self._check_reachable(target)
                    reply = RegistryStub(self._peer_channel(target)).Vote(
                        request, timeout=vote_timeout)
                except (_Partitioned, grpc.RpcError):
                    return
                with self._lock:
                    self._adopt_term(
                        reply.term,
                        f"higher term from {target} vote reply")
                with vote_lock:
                    if _position_ahead(reply, request):
                        ahead[0] = True
                    if reply.granted:
                        grants[0] += 1
            finally:
                with vote_lock:
                    finished[0] += 1
                    if finished[0] == len(self.peers):
                        done.set()

        threads = [threading.Thread(target=solicit, args=(p,), daemon=True)
                   for p in self.peers]
        for t in threads:
            t.start()
        done.wait(vote_timeout)
        with vote_lock:
            return grants[0], ahead[0]

    def _campaign(self, reason: str = "", force: bool = False) -> None:
        try:
            # Chaos lever: a lost/delayed campaign round.
            faultinject.fire("quorum.campaign", node=self.node_id)
        except faultinject.InjectedFault:
            with self._lock:
                self._election_deadline = self._draw_deadline()
            return
        vote_timeout = max(self.election_timeout_s / 2.0, 0.2)
        with self._lock:
            if self.role == LEADER:
                return
            if self._wiped_rejoining_locked():
                # Wiped + mid-rejoin: this member has observed a leader
                # advertise committed records it does not hold yet.
                # Standing now could seat a leader missing committed
                # state (see _wiped_rejoining_locked); wait out the
                # resync instead.
                self._election_deadline = self._draw_deadline()
                return
            my_term = self.term + 1
            last_log_term, last_offset, log_id = self._log_position()
            self._election_deadline = self._draw_deadline()
        if self.peers and not force:
            # Pre-vote: would an election at my_term succeed? Nothing
            # is bumped or persisted on either side, and members
            # hearing from a live leader refuse — so a rejoining
            # member (fresh after a restart, back from a partition)
            # cannot depose a healthy leader once per timeout while it
            # resyncs. Raft's PreVote extension.
            prevote = pb.VoteRequest(
                term=my_term, candidate_id=self.node_id,
                last_log_term=last_log_term,
                last_log_offset=last_offset, log_id=log_id,
                prevote=True)
            pre_grants, pre_ahead = self._gather_votes(prevote,
                                                       vote_timeout)
            if pre_ahead:
                # A live peer is ahead of this member. Yield before
                # bumping any term: the ahead member's own deadline
                # elects it with its full journal, and this member
                # resyncs from it — standing here could seat a leader
                # missing records only that peer still holds.
                with self._lock:
                    self._election_deadline = self._draw_deadline()
                return
            if pre_grants < self.majority:
                return  # stay a quiet follower; probe/retry later
        with self._lock:
            if self.role == LEADER or self.term >= my_term:
                return  # superseded while pre-voting
            self.term = my_term
            self.voted_for = self.node_id
            self.role = CANDIDATE
            self._campaign_t0 = time.monotonic()
            self._save_state()
        M.REGISTRY_TERM.set(float(my_term))
        events.emit(events.REGISTRY_ELECTION, epoch=my_term,
                    node=self.node_id, reason=reason or "election timeout")
        request = pb.VoteRequest(
            term=my_term, candidate_id=self.node_id,
            last_log_term=last_log_term, last_log_offset=last_offset,
            log_id=log_id)
        grants, ahead = self._gather_votes(request, vote_timeout)
        with self._lock:
            if self.role != CANDIDATE or self.term != my_term:
                return  # superseded mid-campaign
            if grants >= self.majority and not ahead:
                self._become_leader()
            else:
                if ahead:
                    # Majority or not, a live voter advertised a log
                    # position ahead of this candidate's. With
                    # in-memory members a committed record can survive
                    # on a single peer (wiped rejoiners vote virgin
                    # positions), so seating this candidate could
                    # erase it on resync — yield and let the ahead
                    # member's own election timeout elect it instead.
                    from_context().warning(
                        "election yielded: a voter is ahead",
                        term=my_term, grants=grants)
                self.role = FOLLOWER
                self._election_deadline = self._draw_deadline()

    def _log_position(self) -> tuple[int, int, str]:
        """(last_log_term, highest contiguous offset, log_id) — the
        up-to-date-ness this member campaigns and votes with: its own
        journal when it led more recently than it followed, else the
        position it reached in the last leader's journal."""
        if self.log_term >= self._received_term:
            return self.log_term, self.log.next_offset, self.log.log_id
        return self._received_term, self._received, self._received_log_id

    def _wiped_rejoining_locked(self) -> bool:
        """Caller holds ``self._lock``. True while this member is a
        wiped rejoiner: its own position is virgin (never led, never
        completed a resync) yet it has already seen a leader advertise
        committed records. In-memory members lose their journal across
        a restart, so Raft's durable-log premise does not hold here: a
        restarted-empty candidate plus a restarted-empty voter form a
        majority that can elect a leader MISSING committed records,
        whose snapshot resync then erases them from the one member
        that still held them (the 100-replica rolling-restart rung
        reproduced exactly this under heartbeat fan-in load). Until
        its first resync lands (SNAPSHOT_END), such a member neither
        stands for election nor endorses another virgin candidate. A
        genuine cold boot has no commit evidence anywhere, so first
        elections are unaffected; and a member that merely heard a
        campaign (a term, no commit offset) is likewise unaffected.
        Virginity is judged by _log_position — the exact position this
        member would campaign and vote with — so the guard can never
        disagree with the VoteRequest it suppresses."""
        last_log_term, last_offset, _ = self._log_position()
        virgin = last_log_term == 0 and last_offset == 0
        return virgin and self._leader_commit > 0

    def _become_leader(self) -> None:
        """Caller holds ``self._lock`` and verified a majority of
        grants at the current term."""
        # Apply the buffered uncommitted tail first: any record the old
        # leader COMMITTED is in here (majorities intersect + the vote
        # rule); records it never committed were never acknowledged, so
        # applying them is idempotent-retry semantics, not divergence.
        pending, self._pending = self._pending, []
        for rec in pending:
            self._apply_record(rec)
        self.role = LEADER
        self._leader_addr = self.node_id
        self.log = ReplicationLog()
        self.log_term = self.term
        self.commit_offset = 0
        self._uncommitted.clear()
        self._append_meta.clear()
        self._match = {}
        now = time.monotonic()
        # Fresh grace for every peer: the step-down check must not fire
        # before followers have had one beat to find us and ack.
        self._contact = {p: now for p in self.peers}
        self._received = 0
        self._received_log_id = ""
        self._in_snapshot = False
        self._snapshot_seen = set()
        M.REGISTRY_ROLE.set(1.0)
        M.REGISTRY_COMMIT_INDEX.set(0.0)
        M.REGISTRY_PROMOTIONS.inc()
        M.REGISTRY_READ_LAG.set(0.0)  # leaders serve committed state
        if self._campaign_t0:
            M.REGISTRY_ELECTION_SECONDS.observe(
                time.monotonic() - self._campaign_t0)
            self._campaign_t0 = 0.0
        events.emit(events.REGISTRY_PROMOTION, epoch=self.term,
                    node=self.node_id, reason="election won")
        from_context().warning("elected LEADER", term=self.term,
                               members=self.cluster_size)
        # Write the registry's own liveness baseline into the fresh
        # journal: followers resyncing by snapshot see committed state.
        self._wake.set()

    # -- Vote / Ack handlers (service-authorized) --------------------------

    def on_vote(self, request, context):
        try:
            self._check_reachable(request.candidate_id)
        except _Partitioned:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "partitioned (chaos lever)")
        if request.prevote:
            # Nothing adopted, nothing persisted, no timer reset: just
            # "would I vote for you?". Refused while hearing from a
            # live leader (or being one) — leader stickiness, the half
            # of PreVote that stops rejoin thrash.
            with self._lock:
                has_live_leader = self.role == LEADER or (
                    bool(self._leader_addr)
                    and time.monotonic() - self._last_contact
                    < self.election_timeout_s)
                granted = (not has_live_leader
                           and request.term >= self.term
                           and self._candidate_up_to_date(request))
                return self._vote_reply_locked(granted)
        with self._lock:
            if request.term > self.term:
                self._adopt_term(
                    request.term,
                    f"vote solicitation from {request.candidate_id}")
            granted = False
            if request.term == self.term \
                    and self.voted_for in ("", request.candidate_id) \
                    and self.role != LEADER \
                    and self._candidate_up_to_date(request):
                self.voted_for = request.candidate_id
                self._save_state()
                granted = True
                # Granting is leader-liveness-adjacent: restart the
                # clock so this member does not immediately campaign
                # against the candidate it just endorsed.
                self._election_deadline = self._draw_deadline()
                self._leader_addr = request.candidate_id
            return self._vote_reply_locked(granted)

    def _vote_reply_locked(self, granted: bool):
        """Caller holds ``self._lock``. Every vote reply — granted or
        not, pre-vote or real — advertises the voter's own log position
        so the candidate can yield the election when a live voter is
        ahead of it (see _campaign)."""
        my_term, my_offset, my_log_id = self._log_position()
        return pb.VoteReply(term=self.term, granted=granted,
                            last_log_term=my_term,
                            last_log_offset=my_offset,
                            log_id=my_log_id)

    def _candidate_up_to_date(self, request) -> bool:
        """Caller holds ``self._lock``. Raft's election restriction:
        grant only when the candidate's log is at least as up-to-date —
        (term, offset) with offsets comparable only within one journal
        id (mismatched ids compare on term alone; see module
        docstring)."""
        my_term, my_offset, my_log_id = self._log_position()
        if (request.last_log_term == 0 and request.last_log_offset == 0
                and self._wiped_rejoining_locked()):
            # A virgin candidate soliciting a wiped rejoiner: neither
            # holds the committed records this voter KNOWS exist
            # (_leader_commit > 0) — granting could seat a leader
            # whose resync erases them. Non-virgin candidates fall
            # through to the ordinary position comparison.
            return False
        if request.last_log_term != my_term:
            return request.last_log_term > my_term
        if request.log_id == my_log_id:
            return request.last_log_offset >= my_offset
        return True

    def on_ack(self, request, context):
        try:
            self._check_reachable(request.node_id)
        except _Partitioned:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "partitioned (chaos lever)")
        advance = False
        with self._lock:
            if request.term > self.term:
                self._adopt_term(request.term,
                                 f"higher term in ack from "
                                 f"{request.node_id}")
            if (self.role == LEADER and request.term == self.term
                    and request.log_id == self.log.log_id):
                prev = self._match.get(request.node_id, 0)
                self._match[request.node_id] = max(
                    prev, request.received_offset)
                self._contact[request.node_id] = time.monotonic()
                known = True
                advance = True
            else:
                known = False
            term = self.term
            commit = self.commit_offset if self.role == LEADER else 0
        if advance:
            self._maybe_advance_commit()
            with self._lock:
                commit = self.commit_offset
        return pb.AckReply(term=term, commit_offset=commit, known=known)

    # -- the Replicate stream (leader side) --------------------------------

    def serve(self, request, context):
        """Generator behind ``Registry.Replicate`` for a quorum member
        (authorization already checked by the service)."""
        try:
            self._check_reachable(request.node_id)
        except _Partitioned:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "partitioned (chaos lever)")
        with self._lock:
            if request.epoch > self.term:
                self._adopt_term(request.epoch,
                                 "superseded by Replicate peer")
            my_term = self.term
            role = self.role
            commit = self.commit_offset
        yield pb.ReplicateRecord(
            kind=KIND_HELLO,
            offset=self.log.next_offset,
            epoch=my_term,
            primary_lease_seconds=self.election_timeout_s,
            log_id=self.log.log_id,
            role=role,
            commit_offset=commit,
        )
        if request.probe:
            return
        if role != LEADER or self.role != LEADER:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "follower does not serve the journal; replicate from "
                "the leader"
                + (f" leader={self._leader_addr}"
                   if self._leader_addr else ""),
            )
        # A follower opening a stream declares everything it holds
        # (from_offset within this journal; nothing, when its log_id
        # differs or it resyncs from scratch). Clamp its match entry to
        # that claim: on_ack keeps the running max, so without this a
        # follower that restarted EMPTY would still be counted at its
        # pre-restart offset and records could commit on a majority
        # that no longer holds them — the rolling-restart data-loss
        # seen at 100-replica heartbeat fan-in.
        if request.node_id:
            held = (request.from_offset
                    if request.log_id == self.log.log_id else 0)
            with self._lock:
                prev = self._match.get(request.node_id, 0)
                if held < prev:
                    self._match[request.node_id] = held
        # Pin the journal this stream serves: a step-down + re-election
        # while the generator is suspended in a yield would otherwise
        # resume collecting from the FRESH journal at the stale cursor,
        # silently skipping the new term's first records. On identity
        # change the stream ends and the follower's reconnect resyncs.
        stream_log = self.log
        cursor = (
            request.from_offset
            if request.log_id == stream_log.log_id else None
        )
        beat = self._beat()
        last_beat = time.monotonic()
        while context.is_active() and self.role == LEADER \
                and self.log is stream_log:
            try:
                self._check_reachable(request.node_id)
            except _Partitioned:
                context.abort(grpc.StatusCode.UNAVAILABLE,
                              "partitioned (chaos lever)")
            if cursor is None:
                cursor = yield from self._snapshot_records()
                continue
            records, needs_snapshot = stream_log.collect(cursor,
                                                         timeout=beat)
            if needs_snapshot:
                cursor = None
                continue
            commit = self.commit_offset
            for rec in records:
                # Copy: the log's record objects are shared across
                # follower streams; the commit stamp is per-yield.
                out = pb.ReplicateRecord()
                out.CopyFrom(rec)
                out.commit_offset = commit
                yield out
                cursor = rec.offset + 1
            now = time.monotonic()
            if now - last_beat >= beat:
                yield pb.ReplicateRecord(
                    kind=KIND_HEARTBEAT,
                    offset=stream_log.next_offset,
                    epoch=self.term,
                    commit_offset=self.commit_offset,
                )
                last_beat = now

    def _snapshot_records(self):
        """Stream a snapshot of COMMITTED state; tailing resumes at the
        commit offset so the uncommitted tail is re-delivered and lands
        in the follower's pending buffer (a record must never skip the
        commit gate by riding a snapshot)."""
        with self._lock:
            resume = self.commit_offset
        yield pb.ReplicateRecord(kind=KIND_SNAPSHOT_BEGIN,
                                 commit_offset=resume)
        entries = get_registry_entries(self.db, "")
        for path in sorted(entries):
            remaining = self.leases.remaining(path)
            if remaining is None:
                ttl = 0.0
            elif remaining > 0:
                ttl = remaining
            else:
                ttl = 1e-3  # already expired: stale immediately, not never
            yield pb.ReplicateRecord(
                kind=KIND_KV,
                value=pb.Value(path=path, value=entries[path],
                               lease_seconds=ttl),
                commit_offset=resume,
            )
        yield pb.ReplicateRecord(kind=KIND_SNAPSHOT_END, offset=resume,
                                 commit_offset=resume)
        return resume

    # -- follower side: find the leader, follow, ack -----------------------

    def start(self) -> None:
        for target in (self._main_loop, self._tail_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        with self._cond:
            self._cond.notify_all()
        call = self._call
        if call is not None:
            call.cancel()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        self._pool.close()

    def _pause(self, timeout: float) -> bool:
        self._wake.wait(timeout)
        self._wake.clear()
        return self._stop.is_set()

    def _main_loop(self) -> None:
        """The election timer (followers) and the majority-contact
        step-down check (leaders)."""
        tick = max(min(self.election_timeout_s / 10.0, 0.1), 0.02)
        while not self._stop.wait(tick):
            now = time.monotonic()
            if self.role == LEADER:
                if self.majority == 1:
                    continue
                with self._lock:
                    heard = sum(
                        1 for t in self._contact.values()
                        if now - t <= self.stepdown_grace_s)
                if 1 + heard < self.majority:
                    self._step_down(
                        f"heard {heard} of {len(self.peers)} peers "
                        f"within {self.stepdown_grace_s:.1f}s")
            elif self.role == FOLLOWER:
                with self._lock:
                    due = now >= self._election_deadline
                if due:
                    self._campaign()

    def _tail_loop(self) -> None:
        """As follower: find the leader and follow its journal. As
        leader: nothing (the stream is pull; followers come to us)."""
        log = from_context()
        while not self._stop.is_set():
            if self.role != FOLLOWER:
                if self._pause(self._beat()):
                    return
                continue
            target = self._leader_addr
            if not target or target in self._unreachable:
                target = self._find_leader()
            if not target:
                if self._pause(max(self.election_timeout_s / 4, 0.05)):
                    return
                continue
            try:
                self._follow_once(target)
            except _StaleEpoch:
                with self._lock:
                    if self._leader_addr == target:
                        self._leader_addr = ""
            except (_Partitioned, grpc.RpcError) as err:
                if isinstance(err, grpc.RpcError):
                    self._pool.maybe_evict(err, target)
                    detail = err.details() or str(err.code())
                else:
                    detail = "partitioned"
                log.debug("quorum follow failed", leader=target,
                          error=detail)
                with self._lock:
                    if self._leader_addr == target:
                        self._leader_addr = ""
            except faultinject.InjectedFault:
                pass  # armed replication.apply: sever the stream, retry
            if self._pause(backoff.jittered(
                    max(self.election_timeout_s / 8, 0.02))):
                return

    def _find_leader(self) -> str:
        """Probe peers for a HELLO claiming LEADER at >= our term."""
        for target in self.peers:
            if self._stop.is_set() or target in self._unreachable:
                continue
            try:
                call = RegistryStub(self._peer_channel(target)).Replicate(
                    pb.ReplicateRequest(
                        epoch=self.term, probe=True,
                        node_id=self.node_id),
                    timeout=max(self.election_timeout_s / 2, 0.2))
                hello = next(iter(call), None)
            except grpc.RpcError as err:
                self._pool.maybe_evict(err, target)
                continue
            if hello is None or hello.kind != KIND_HELLO:
                continue
            with self._lock:
                self._adopt_term(hello.epoch,
                                 f"probe found term {hello.epoch} at "
                                 f"{target}")
                if hello.role == LEADER and hello.epoch >= self.term:
                    self._leader_addr = target
                    return target
        return ""

    def _follow_once(self, target: str) -> None:
        self._check_reachable(target)
        with self._lock:
            same_log = self._received_log_id
            request = pb.ReplicateRequest(
                from_offset=self._received,
                epoch=self.term,
                log_id=same_log,
                node_id=self.node_id,
            )
        call = RegistryStub(self._peer_channel(target)).Replicate(request)
        self._call = call
        try:
            for rec in call:
                if self._stop.is_set() or self.role != FOLLOWER:
                    call.cancel()
                    return
                self._check_reachable(target)
                self._apply_stream_record(rec, target)
        finally:
            self._call = None
            self._in_snapshot = False
            self._snapshot_seen = set()

    def _apply_stream_record(self, rec, leader: str) -> None:
        faultinject.fire("replication.apply", kind=rec.kind)
        now = time.monotonic()
        if rec.kind == KIND_HELLO:
            with self._lock:
                if rec.epoch < self.term:
                    raise _StaleEpoch(rec.epoch)
                self._adopt_term(rec.epoch, f"hello from {leader}")
                self._stream_log_id = rec.log_id
                self._stream_term = rec.epoch
                self._leader_commit = rec.commit_offset
                self._last_contact = now
                self._election_deadline = self._draw_deadline()
            return
        if rec.kind == KIND_SNAPSHOT_BEGIN:
            self._in_snapshot = True
            self._snapshot_seen = set()
        elif rec.kind == KIND_KV and self._in_snapshot:
            # Snapshot entries are committed state: apply directly.
            self.service.apply_kv(rec.value.path, rec.value.value,
                                  rec.value.lease_seconds)
            if rec.value.value != "":
                self._snapshot_seen.add(rec.value.path)
            M.REPL_RECORDS_APPLIED.inc()
        elif rec.kind == KIND_SNAPSHOT_END:
            for path in set(get_registry_entries(self.db, "")) \
                    - self._snapshot_seen:
                self.service.apply_kv(path, "", 0.0)
            self._in_snapshot = False
            self._snapshot_seen = set()
            with self._lock:
                self._received = rec.offset
                self._received_log_id = self._stream_log_id
                self._received_term = self._stream_term
                self._pending = []
                self._leader_commit = max(self._leader_commit,
                                          rec.commit_offset)
            compact = getattr(self.db, "compact", None)
            if compact is not None:
                compact()
            self._send_ack(leader)
        elif rec.kind in (KIND_KV, KIND_RENEW):
            with self._lock:
                if rec.offset == self._received:
                    self._received = rec.offset + 1
                    self._pending.append(rec)
                self._leader_commit = max(self._leader_commit,
                                          rec.commit_offset)
            self._flush_pending()
            self._send_ack(leader)
        elif rec.kind == KIND_HEARTBEAT:
            with self._lock:
                if rec.epoch < self.term:
                    raise _StaleEpoch(rec.epoch)
                self._leader_commit = max(self._leader_commit,
                                          rec.commit_offset)
            self._flush_pending()
            self._send_ack(leader)
        with self._lock:
            self._last_contact = now
            self._election_deadline = self._draw_deadline()
            if self.role == FOLLOWER:
                M.REPL_LAG_RECORDS.set(float(len(self._pending)))
                M.REPL_LAG_SECONDS.set(0.0)
                M.REGISTRY_COMMIT_INDEX.set(float(self._leader_commit))
                M.REGISTRY_READ_LAG.set(float(self._read_lag_locked()))

    def _read_lag_locked(self) -> int:
        """Committed records this follower cannot yet serve: the
        received-but-unapplied tail plus records it knows committed but
        has not received. This is the raft read-index gap — between a
        record landing here (acked, counted toward the leader's
        majority) and the NEXT leader contact advertising the commit,
        a follower GetValues trails the leader by one ack round-trip
        (doc/architecture.md, Control plane at scale)."""
        return (len(self._pending)
                + max(0, self._leader_commit - self._received))

    def _flush_pending(self) -> None:
        """Apply buffered records the leader has since committed — the
        commit gate on the follower side."""
        with self._lock:
            ready = [r for r in self._pending
                     if r.offset < self._leader_commit]
            self._pending = [r for r in self._pending
                             if r.offset >= self._leader_commit]
        for rec in ready:
            self._apply_record(rec)
        if ready:
            with self._lock:
                M.REGISTRY_READ_LAG.set(float(self._read_lag_locked()))

    def _send_ack(self, leader: str) -> None:
        """Report the held offset to the leader (best-effort); a higher
        term in the reply demotes us off this stream."""
        with self._lock:
            request = pb.AckRequest(
                term=self.term, node_id=self.node_id,
                received_offset=self._received,
                log_id=self._received_log_id)
        try:
            self._check_reachable(leader)
            reply = RegistryStub(self._peer_channel(leader)).Ack(
                request, timeout=max(self.election_timeout_s / 2, 0.2))
        except (_Partitioned, grpc.RpcError):
            return  # the stream's own failure handling covers this
        with self._lock:
            if reply.term > self.term:
                self._adopt_term(reply.term, f"ack reply from {leader}")
                raise _StaleEpoch(reply.term)
            if reply.known:
                self._leader_commit = max(self._leader_commit,
                                          reply.commit_offset)
        self._flush_pending()

    # -- status ------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            st = {
                "role": self.role,
                "epoch": self.term,
                "term": self.term,
                "peer": ",".join(self.peers),
                "node_id": self.node_id,
                "commit_offset": (self.commit_offset
                                  if self.role == LEADER
                                  else self._leader_commit),
                "next_offset": self.log.next_offset,
                "leader": self.leader_hint(),
                "members": self.cluster_size,
                "lag_records": (max(0, self._leader_commit - self._received)
                                if self.role == FOLLOWER else 0),
                "lag_seconds": (round(
                    time.monotonic() - self._last_contact, 3)
                    if self.role == FOLLOWER else 0.0),
            }
        journal_bytes = getattr(self.db, "journal_bytes", None)
        st["journal_bytes"] = journal_bytes() if journal_bytes else 0
        return st

    def status_entries(self) -> dict[str, str]:
        """The virtual ``registry/...`` KV view (merged into GetValues
        replies; never stored, leased, or replicated)."""
        st = self.status()
        return {
            "registry/role": st["role"],
            "registry/epoch": str(st["epoch"]),
            "registry/term": str(st["term"]),
            "registry/leader": st["leader"],
            "registry/peer": st["peer"],
            "registry/members": str(st["members"]),
            "registry/replication/commit_offset":
                str(st["commit_offset"]),
            "registry/replication/next_offset": str(st["next_offset"]),
            "registry/replication/lag_records": str(st["lag_records"]),
            "registry/replication/lag_seconds":
                f"{st['lag_seconds']:.3f}",
            "registry/replication/journal_bytes":
                str(st["journal_bytes"]),
        }
