"""In-process cluster simulator (``oim_tpu/chaos/sim.py``): the chaos
ladder's substrate, over the port's engines, registry and router.

Two halves:

* :class:`EngineSim`, the engine half, which needs neither grpcio nor
  protobuf: one **MetricsServer** and a fresh flight-recorder ring per
  sim, so convergence assertions read heal events the way an operator
  would (``GET /debug/events`` over HTTP), bare serve engines on the
  sim's device (:class:`EngineReplica`), and the per-engine leak census.
  The rungs that drive the engine alone run over it on the card.
* :class:`ClusterSim`, which extends it with the control plane:
  a **registry** (single node, a replicated primary/standby pair with a
  short auto-promotion lease, or a 3-node quorum, all the port's copies
  in ``registry/``), **N malloc-backed controllers** running real
  heartbeat loops at one mesh coordinate, **M serve replicas**
  (:class:`ReplicaHandle`: engine + gRPC server + TTL-leased
  registration) behind the port's router with ``kill()`` (SIGKILL
  semantics: row outlives the corpse), ``drain()`` (SIGTERM semantics),
  ``kill_listener()`` / ``restart_listener()`` (black-holed endpoint)
  and ``restart()``, and a **feeder** factory over the controllers.

Everything lives in one process on localhost TCP; determinism comes from
the ladder's seeded schedule (``chaos/ladder.py``), not from mocking
time. The model is the test suite's tiny llama (``model``), its weights
drawn from a seeded CPU generator so that every device holds the same
ones. The gRPC half imports grpcio and protobuf inside the functions that
need them: importing this module, and running an ``EngineSim``, loads
neither.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import tempfile
import threading
import time
import urllib.request

import torch

from oim_tpu_torch.common import events
from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.common.metrics import MetricsServer
from oim_tpu_torch.common.pathutil import REGISTRY_SERVE

# One mesh coordinate for every sim controller: the feeder's failover
# elects replacements among same-coordinate replicas.
MESH_COORD = "0,0,0"

EVENTS_RING = 8192


def _device_key(device) -> str:
    """The cache key of a device: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


@functools.lru_cache(maxsize=None)
def _tiny(seed: int, device: str):
    from oim_tpu_torch.models import llama

    cfg = llama.tiny(vocab=64, dim=32, n_layers=2)
    params = llama.init(torch.Generator().manual_seed(seed), cfg, device="cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(device)

    return to(params), cfg


def model(device="cuda"):
    """The sim's tiny target model on ``device`` (cached per device: every
    sim and solo reference of a process shares it)."""
    return _tiny(0, _device_key(device))


def draft_model(device="cuda"):
    """A genuinely DIFFERENT draft (independent init): its proposals
    disagree with the target often, so the draft-collapse rung's valve
    gives up on it."""
    return _tiny(7, _device_key(device))


def solo_tokens(prompt, n_new, temperature=0.0, seed=0, max_seq=64, device="cuda"):
    """The byte-identity reference: what a solo generate() emits for this
    request. A sampled request draws from a generator seeded as the engine
    seeds the request's, so its stream equals the engine's own."""
    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve.engine import _generator

    params, cfg = model(device)
    dev = torch.device(_device_key(device))
    with torch.inference_mode():
        out = gen.generate(
            params, torch.tensor([list(prompt)], dtype=torch.long, device=dev), n_new,
            cfg, temperature=temperature,
            rng=_generator(seed, dev) if temperature > 0 else None, max_seq=max_seq)
    return out[0, len(prompt):].tolist()


class StreamDiverged(AssertionError):
    """An engine's or a routed stream that differs from its solo
    reference; carries both, so a caller can read where they part."""

    def __init__(self, message: str, prompt, got, expect):
        super().__init__(message)
        self.prompt = list(prompt)
        self.got = list(got)
        self.expect = list(expect)


def wait_for(predicate, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


class EngineReplica:
    """One bare serve engine on the sim's device, with the engine-side
    fault levers."""

    def __init__(self, sim: "EngineSim", rid: str, engine_kwargs: dict,
                 version: str = ""):
        self.sim = sim
        self.rid = rid
        self.engine_kwargs = dict(engine_kwargs)
        self.version = version
        self.engine = None
        self.alive = False

    def _boot_engine(self) -> None:
        from oim_tpu_torch.serve import ServeEngine

        kwargs = dict(self.engine_kwargs)
        if kwargs.pop("_draft", False):
            dparams, dcfg = draft_model(self.sim.device)
            kwargs.setdefault("draft_params", dparams)
            kwargs.setdefault("draft_cfg", dcfg)
        if int(kwargs.get("shard", 1)) > 1:
            # Every member on the sim's device (two members may share a
            # card, as the port's sharded serving allows).
            kwargs.setdefault("devices", [self.sim.device] * int(kwargs["shard"]))
        params, cfg = model(self.sim.device)
        self.engine = ServeEngine(params, cfg, name=self.rid, device=self.sim.device,
                                  **kwargs)

    def boot(self) -> None:
        self._boot_engine()
        self.alive = True

    def kill(self) -> None:
        """SIGKILL semantics: the engine stops mid-flight and emits no
        drain event (a killed process emits nothing)."""
        self.engine.stop(drain=False, timeout=30, quiet=True)
        self.alive = False

    def completed(self) -> int:
        """Lifetime requests this replica's engine has finished (any
        reason): MONOTONE, unlike the engine's QPS window."""
        return self.engine.finished_total

    def shutdown(self) -> None:
        if not self.alive:
            return
        try:
            self.kill()
        except Exception:  # noqa: BLE001 - teardown best-effort
            self.alive = False


class EngineSim:
    """The engine half of the sim: engines on ``device``, the metrics
    server, a fresh event ring, the heal-signature reads and the
    per-engine leak census. Use as a context manager."""

    replica_class = EngineReplica

    def __init__(self, *, replicas: int = 2, max_batch: int = 2, max_seq: int = 64,
                 queue_depth: int = 64, engine_kwargs: list[dict] | None = None,
                 device="cuda"):
        self.device = torch.device(_device_key(device))
        self.n_replicas = replicas
        self.engine_defaults = dict(
            max_batch=max_batch, max_seq=max_seq, queue_depth=queue_depth)
        self.engine_kwargs = engine_kwargs or []
        self.replicas: list = []
        self.metrics_srv = None
        # Set by mark_faults(): where this sim's fault schedule began.
        self.fault_mark = 0

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self):
        try:
            self.start()
        except BaseException:
            self.stop()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _open(self) -> None:
        # A fresh flight-recorder ring per sim: convergence assertions
        # must read THIS cluster's incidents, not an earlier test's.
        events.configure(capacity=EVENTS_RING)
        self.metrics_srv = MetricsServer(port=0).start()

    def _boot_replicas(self) -> None:
        for i in range(self.n_replicas):
            kwargs = dict(self.engine_defaults)
            if i < len(self.engine_kwargs):
                kwargs.update(self.engine_kwargs[i])
            handle = self.replica_class(self, f"r{i}", kwargs)
            handle.boot()
            self.replicas.append(handle)

    def start(self) -> None:
        self._open()
        self._boot_replicas()

    def _stop_replicas(self) -> None:
        for handle in self.replicas:
            handle.shutdown()

    def _close(self) -> None:
        if self.metrics_srv is not None:
            self.metrics_srv.stop()
        events.configure()  # restore the default ring for later tests

    def stop(self) -> None:
        self._stop_replicas()
        self._close()

    # -- client load -------------------------------------------------------

    def warm(self) -> None:
        """One tiny request per engine: first calls warm outside any
        timed or asserted window."""
        handles = [r.engine.submit([1, 2, 3], max_new=2)
                   for r in self.replicas if r.alive]
        for h in handles:
            h.result(timeout=300)

    def check_stream(self, prompt, n_new, temp, seed, toks, what: str) -> None:
        """Raise ``StreamDiverged`` unless ``toks`` equals the request's
        solo reference on this sim's device."""
        expect = solo_tokens(prompt, n_new, temperature=temp, seed=seed,
                             device=self.device)
        if toks != expect:
            raise StreamDiverged(f"{what}: {toks} != {expect}", prompt, toks, expect)

    def assert_byte_identity(self, reqs, results) -> int:
        """Every non-None result must equal its solo generate() run.
        Returns how many results were checked."""
        checked = 0
        for (prompt, n_new, temp, seed), toks in zip(reqs, results):
            if toks is None:
                continue
            self.check_stream(
                prompt, n_new, temp, seed, toks,
                f"routed output diverged from solo generate() for "
                f"prompt={prompt} temp={temp} seed={seed}")
            checked += 1
        return checked

    # -- convergence: /debug/events over HTTP ------------------------------

    def debug_events(self, type_: str = "") -> list[dict]:
        """The flight recorder as an operator reads it: ``GET
        /debug/events`` on the sim's metrics server."""
        url = f"http://127.0.0.1:{self.metrics_srv.port}/debug/events"
        if type_:
            url += f"?type={type_}"
        doc = json.loads(urllib.request.urlopen(url, timeout=10).read())
        return doc.get("events", [])

    def event_mark(self) -> int:
        """The newest event seq: rungs scope their convergence reads to
        'events after this point'."""
        evs = self.debug_events()
        return evs[-1]["seq"] if evs else 0

    def mark_faults(self) -> int:
        """Record 'the fault schedule starts HERE': the ladder scopes the
        rung's final heal-signature check to events after this seq, so
        pre-fault warm/baseline traffic can never pollute the declared
        first-occurrence order. Returns the mark."""
        self.fault_mark = self.event_mark()
        return self.fault_mark

    def heal_signature(self, expect, mark: int = 0) -> list[str]:
        """First-occurrence order of the ``expect`` event types among
        events with seq > mark: the rung's observed heal sequence."""
        seen: list[str] = []
        for ev in self.debug_events():
            if ev["seq"] <= mark:
                continue
            if ev["type"] in expect and ev["type"] not in seen:
                seen.append(ev["type"])
        return seen

    def wait_heal(self, expect, mark: int = 0,
                  timeout: float = 30.0) -> list[str]:
        """Block until every type in ``expect`` has fired since ``mark``;
        returns (and the ladder asserts on) their first-occurrence
        order."""
        expect = list(expect)

        def done():
            return set(self.heal_signature(expect, mark)) >= set(expect)

        if not wait_for(done, timeout=timeout):
            raise AssertionError(
                f"heal did not converge: wanted {expect}, saw "
                f"{self.heal_signature(expect, mark)} in /debug/events")
        return self.heal_signature(expect, mark)

    # -- invariants --------------------------------------------------------

    def _census(self) -> tuple[dict, list[str]]:
        """The per-engine census over every LIVE replica and its leaks:
        no occupied slots, no queued work, every page either free or held
        by the prefix store (one store entry == one page ref), a drained
        draft pool, and a consistent in-budget host tier."""
        leaks: list[str] = []
        census: dict = {"replicas": {}}
        for handle in self.replicas:
            if not handle.alive:
                continue
            engine = handle.engine
            pool = engine.pool_stats()
            prefix = engine.prefix_stats()
            spec = engine.spec_stats()
            host = engine.host_stats()
            row = {
                "active_slots": engine.active_slots,
                "queued": engine.queue_len,
                "used_pages": pool["used_pages"],
                "prefix_entries": prefix["entries"],
                "draft_used_pages": spec["draft_used_pages"],
                "host_entries": host["entries"],
                "host_bytes": host["bytes"],
            }
            census["replicas"][handle.rid] = row
            if row["active_slots"] or row["queued"]:
                leaks.append(f"{handle.rid}: live work left "
                             f"({row['active_slots']} slots, "
                             f"{row['queued']} queued)")
            if row["used_pages"] != row["prefix_entries"]:
                leaks.append(
                    f"{handle.rid}: {row['used_pages']} pages used but "
                    f"only {row['prefix_entries']} prefix-store refs — "
                    f"a retired slot leaked pages")
            if row["draft_used_pages"]:
                leaks.append(f"{handle.rid}: {row['draft_used_pages']} "
                             f"draft pages leaked")
            # Host tier: entries and bytes must agree (move semantics
            # keep a block in ONE tier) and the budget must hold.
            if bool(row["host_entries"]) != bool(row["host_bytes"]):
                leaks.append(
                    f"{handle.rid}: host tier skewed "
                    f"({row['host_entries']} entries, "
                    f"{row['host_bytes']} bytes)")
            if row["host_bytes"] > host["capacity_bytes"]:
                leaks.append(
                    f"{handle.rid}: host tier over budget "
                    f"({row['host_bytes']} > {host['capacity_bytes']})")
        return census, leaks

    def leak_census(self) -> dict:
        """Zero-leak census (``_census``). Returns the census; raises on
        any leak."""
        census, leaks = self._census()
        if leaks:
            raise AssertionError("leak census failed: " + "; ".join(leaks))
        return census


class ReplicaHandle(EngineReplica):
    """One serve replica (engine + server + registration) with the fault
    levers a chaos rung pulls."""

    def __init__(self, sim: "ClusterSim", rid: str, engine_kwargs: dict,
                 version: str = ""):
        super().__init__(sim, rid, engine_kwargs, version)
        self.server = None
        self.service = None
        self.registration = None
        self.members = None

    def boot(self, endpoint: str = "tcp://127.0.0.1:0") -> None:
        from oim_tpu_torch.serve.members import ShardMembers
        from oim_tpu_torch.serve.registration import ServeRegistration
        from oim_tpu_torch.serve.service import ServeService, serve_server

        self._boot_engine()
        if self.engine.shard > 1:
            # Member leases BEFORE the serve row's first beat: the row's
            # ready field folds in member_counts(), and registering
            # not-ready would make the router skip a healthy boot.
            self.members = ShardMembers(
                self.rid, self.engine.shard, self.sim.registry_address,
                interval=self.sim.heartbeat_s, pool=self.sim.pool).start()
            self.engine.set_member_watch(self.members.member_counts)
        self.service = ServeService(self.engine)
        self.server = serve_server(endpoint, self.service)
        self.registration = ServeRegistration(
            self.rid, self.server.addr, self.engine,
            self.sim.registry_address,
            interval=self.sim.heartbeat_s, pool=self.sim.pool,
            version=self.version)
        self.registration.beat_once()  # deterministic first registration
        self.registration.start()
        self.alive = True

    # -- fault levers ------------------------------------------------------

    def kill(self) -> None:
        """SIGKILL semantics: heartbeats stop mid-lease, the listener
        dies, nothing deregisters — the row outlives the corpse and the
        router must retry its way off it. ``quiet``: a SIGKILLed process
        emits no drain event either, and a spurious REPLICA_DRAIN would
        pollute the heal signatures the ladder asserts first-occurrence
        order on."""
        self.registration.stop(deregister=False)
        if self.members is not None:
            self.members.stop(deregister=False)
        self.server.force_stop()
        self.engine.stop(drain=False, timeout=30, quiet=True)
        self.alive = False

    def drain(self) -> None:
        """SIGTERM semantics: announce ready:false so routers rotate
        away, finish every resident stream, deregister, then stop the
        listener (cli/oim_serve.py's shutdown order)."""
        self.registration.announce_draining()
        self.engine.stop(drain=True, timeout=60)
        self.registration.stop(deregister=True)
        if self.members is not None:
            self.members.stop(deregister=True)
        self.server.stop(grace=5.0)
        self.alive = False

    def kill_listener(self) -> None:
        """Black-hole the endpoint: the engine and its heartbeat stay
        alive (the row keeps refreshing, ready:true) but the socket is
        gone — established router channels ride a dead transport until
        ``maybe_evict`` drops them."""
        self.server.force_stop()

    def restart_listener(self) -> None:
        """Bring the SAME engine back on the SAME address: recovery
        requires the router's next pick to re-dial a fresh channel."""
        from oim_tpu_torch.serve.service import serve_server

        addr = self.server.addr
        self.server = serve_server(f"tcp://{addr}", self.service)

    def kill_member(self, rank: int) -> None:
        """SIGKILL one non-rank-0 member of a sharded replica: its
        ``serve/<id>.member.<k>`` heartbeats stop mid-lease, nothing
        deregisters, and when the TTL lapses the engine's stats() flips
        the WHOLE replica not-ready."""
        self.members.stop_member(rank)

    def restart_member(self, rank: int) -> None:
        """The killed member rebooted and re-staged its weight slice: a
        fresh publisher re-takes its lease and readiness heals."""
        self.members.restart_member(rank)

    def restart(self, endpoint: str | None = None) -> None:
        """A fresh replica process at the same id (new engine, empty
        caches): the post-crash reboot."""
        self.boot(endpoint or f"tcp://{self.server.addr}")


class ControllerHandle:
    """One malloc-backed controller daemon (service + server +
    heartbeat loop)."""

    def __init__(self, sim: "ClusterSim", cid: str):
        from oim_tpu_torch.controller.controller import (
            Controller,
            controller_server,
        )
        from oim_tpu_torch.controller.malloc_backend import MallocBackend

        self.cid = cid
        self.controller = Controller(
            controller_id=cid, backend=MallocBackend(),
            controller_address="pending",
            registry_address=sim.registry_address,
            registry_delay=sim.controller_delay,
            mesh_coord=MeshCoord.parse(MESH_COORD),
            pool=sim.pool)
        self.server = controller_server(
            "tcp://localhost:0", self.controller.service)
        self.controller.controller_address = self.server.addr
        self.controller.start()
        self.alive = True

    def kill(self) -> None:
        """SIGKILL semantics: heartbeats stop, the lease outlives the
        corpse, data-plane RPCs go UNAVAILABLE."""
        self.controller.stop()
        self.server.force_stop()
        self.alive = False

    def shutdown(self) -> None:
        if self.alive:
            try:
                self.kill()
            except Exception:  # noqa: BLE001 - teardown best-effort
                self.alive = False


class SimReplicaLauncher:
    """The autoscaler's ``ReplicaLauncher`` seam, in-process: spawn boots
    a :class:`ReplicaHandle` inside this sim instead of forking an
    ``oim-serve`` process; drain runs the same SIGTERM-shaped drain path.
    Handles are appended to ``sim.replicas`` BEFORE the background boot
    starts, so the leak census and teardown always see them.

    ``spawn()`` is fire-and-forget like the subprocess launcher: engine
    init takes real time and the reconcile loop must keep ticking through
    it. ``prestage_fn``, when given, is called once per new version
    before its first spawn.
    """

    def __init__(self, sim: "ClusterSim", engine_kwargs: dict | None = None,
                 prestage_fn=None, id_prefix: str = "as"):
        self.sim = sim
        self.engine_kwargs = dict(sim.engine_defaults)
        self.engine_kwargs.update(engine_kwargs or {})
        self.prestage_fn = prestage_fn
        self.id_prefix = id_prefix
        self._seq = itertools.count()
        self._prestaged: set[str] = set()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    def prestage(self, version: str) -> None:
        if self.prestage_fn is None or version in self._prestaged:
            return
        self._prestaged.add(version)
        self.prestage_fn(version)

    def spawn(self, version: str) -> str:
        self.prestage(version)
        with self._lock:
            rid = f"{self.id_prefix}{next(self._seq)}"
        handle = ReplicaHandle(self.sim, rid, self.engine_kwargs,
                               version=version)
        self.sim.replicas.append(handle)
        thread = threading.Thread(target=handle.boot, daemon=True,
                                  name=f"sim-spawn-{rid}")
        with self._lock:
            self._threads.append(thread)
        thread.start()
        return rid

    def drain(self, replica_id: str) -> None:
        for handle in self.sim.replicas:
            if handle.rid == replica_id and handle.alive:
                thread = threading.Thread(
                    target=handle.drain, daemon=True,
                    name=f"sim-drain-{replica_id}")
                with self._lock:
                    self._threads.append(thread)
                thread.start()
                return

    def join(self, timeout: float = 60.0) -> None:
        """Wait out in-flight boots/drains (rung teardown hygiene)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))


class _SimWatcher:
    """A registry Watch consumer with endpoint failover: maintains a live
    dict of rows under ``prefix``, reconnecting (resume token first,
    RESET snapshot when a restarted node cannot honor it) across whatever
    the rung does to the quorum. ``deletes_seen`` counts DELETE/EXPIRED
    deltas observed; the missed/duplicated-delta assertions read ``rows``
    + ``puts_seen``."""

    def __init__(self, sim: "ClusterSim", prefix: str):
        self.sim = sim
        self.prefix = prefix
        self.rows: dict[str, str] = {}
        self.puts_seen = 0
        self.deletes_seen = 0
        self.resyncs = 0
        self.lock = threading.Lock()
        self.synced = threading.Event()
        self._stop = threading.Event()
        self._call = None
        self._token = ""
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        import grpc

        from oim_tpu_torch.registry.watch import WatchConsumer
        from oim_tpu_torch.spec import oim_pb2 as pb
        from oim_tpu_torch.spec.services import RegistryStub

        consumer = WatchConsumer()

        def install(rows: dict) -> None:
            self.puts_seen += len(rows)
            with self.lock:
                self.rows = dict(rows)

        def put(path: str, value: str) -> None:
            self.puts_seen += 1
            with self.lock:
                self.rows[path] = value

        def delete(path: str, expired: bool) -> None:
            self.deletes_seen += 1
            with self.lock:
                self.rows.pop(path, None)

        def on_reset() -> None:
            self.resyncs += 1

        while not self._stop.is_set():
            progressed = [False]
            for _, server, manager in list(self.sim.registries):
                if self._stop.is_set():
                    return
                try:
                    stub = RegistryStub(self.sim.pool.get(
                        server.addr, None, "component.registry"))
                    call = stub.Watch(pb.WatchRequest(
                        path=self.prefix,
                        resume_token=consumer.resume_token))
                    self._call = call

                    def on_sync() -> None:
                        progressed[0] = True
                        self.synced.set()

                    consumer.run(
                        call, install=install, put=put, delete=delete,
                        on_reset=on_reset, on_sync=on_sync,
                        is_stopped=self._stop.is_set)
                except grpc.RpcError as err:
                    self.sim.pool.maybe_evict(err, server.addr)
                finally:
                    self._call = None
            if not progressed[0] and self._stop.wait(0.05):
                return

    def get(self, path: str) -> str | None:
        with self.lock:
            return self.rows.get(path)

    def stop(self) -> None:
        self._stop.set()
        call = self._call
        if call is not None:
            call.cancel()
        self._thread.join(timeout=5.0)


# Synthetic latency grid for lite-replica telemetry rows: the serve
# token-latency shape at coarse resolution — ten ints per row keeps a
# thousand heartbeats' JSON small while still exercising the full
# merge/quantile path of a fleet reader.
_LITE_LE = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


class LiteReplica:
    """A control-plane-complete serve replica with decode stubbed out.

    Everything the control plane SEES from a real replica is real: a
    TTL-leased ``serve/<id>`` load row whose value changes every beat (so
    each heartbeat is a genuine SetValue journal write, quorum commit and
    Watch fan-out), a ``telemetry/<id>`` row carrying mergeable latency
    histograms that grow in bursts (so it exercises BOTH renewal paths:
    full republish on change, batched Heartbeat between), and a
    content-addressed KV-volume advertisement riding the serve row. What
    is missing is everything expensive: no engine, no listener, no device
    memory — one box hosts hundreds of these.

    Beats are DRIVEN (``beat()``), never threaded per replica;
    ``LiteFleet`` shards a fleet over a handful of driver threads.
    """

    def __init__(self, rid: str, registry_address: str, *, pool=None,
                 interval: float = 2.0, metrics_endpoint: str = "",
                 volume_keys: int = 0, max_batch: int = 8, seed: int = 0):
        import random

        from oim_tpu_torch.common.telemetry import (
            RegistryRowPublisher,
            TelemetryRegistration,
        )

        self.rid = rid
        self.max_batch = max_batch
        self._rng = random.Random(f"{seed}:{rid}")
        self._beats = 0
        self._free_slots = max_batch
        self._queue_depth = 0
        self._hist = {
            "first_token": {"le": list(_LITE_LE),
                            "counts": [0] * (len(_LITE_LE) + 1), "sum": 0.0},
            "inter_token": {"le": list(_LITE_LE),
                            "counts": [0] * (len(_LITE_LE) + 1), "sum": 0.0},
        }
        # Stable per-replica volume advertisement: hash -> volume id, the
        # shape serve/kvtier.py exports and router/table.py parses.
        self._volumes = {
            f"{rid}-chain-{j:02d}": f"kv-{rid}-{j:02d}"
            for j in range(volume_keys)
        }
        outer = self

        class _LoadRow(RegistryRowPublisher):
            THREAD_NAME = "oim-lite-serve"

            def snapshot(self) -> dict:
                return outer._load_snapshot()

        # republish_every=1 mirrors ServeRegistration: a load row's value
        # changes every beat, so renewal IS re-publication.
        self.row = _LoadRow(
            f"{REGISTRY_SERVE}/{rid}", registry_address,
            interval=interval, pool=pool, republish_every=1)
        self.telemetry = TelemetryRegistration(
            rid, "serve", metrics_endpoint or f"lite://{rid}",
            registry_address, interval=interval, pool=pool,
            collect=self._collect)

    def _load_snapshot(self) -> dict:
        snap = {
            # Unroutable by design: a scale run times table parses and
            # router picks, it never dials a lite replica.
            "endpoint": f"lite://{self.rid}",
            "free_slots": self._free_slots,
            "queue_depth": self._queue_depth,
            "max_batch": self.max_batch,
            "ready": True,
        }
        if self._volumes:
            snap["prefix_block"] = 16
            snap["prefix_tiers"] = {h: "hbm" for h in self._volumes}
            snap["prefix_volumes"] = dict(self._volumes)
        return snap

    def _observe(self, key: str, value: float) -> None:
        import bisect

        snap = self._hist[key]
        idx = bisect.bisect_left(_LITE_LE, value)
        counts = snap["counts"]
        for j in range(idx, len(counts)):
            counts[j] += 1
        snap["sum"] += value

    def _collect(self) -> dict:
        # Fresh nested containers every call: RegistryRowPublisher detects
        # change by comparing the last published body — handing it our
        # mutable dicts would alias last-published and current and pin
        # the row on the batched-renewal path forever.
        return {"hist": {
            key: {"le": list(s["le"]), "counts": list(s["counts"]),
                  "sum": s["sum"]}
            for key, s in self._hist.items()
        }}

    def register(self) -> None:
        """First publication of both rows (the boot beat)."""
        self.row.beat_once()
        self.telemetry.beat_once()

    def beat(self) -> None:
        """One heartbeat: the decode stub moves the load counters every
        beat and grows the latency histograms only in bursts (the
        telemetry row batch-renews between)."""
        self._beats += 1
        rng = self._rng
        self._queue_depth = rng.randint(0, 3)
        self._free_slots = rng.randint(0, self.max_batch)
        if self._beats % 3 == 1:
            self._observe("first_token", rng.uniform(0.01, 0.4))
            for _ in range(rng.randint(1, 4)):
                self._observe("inter_token", rng.uniform(0.002, 0.06))
        self.row.beat_once()
        self.telemetry.beat_once()

    def stop(self, deregister: bool = True) -> None:
        self.row.stop(deregister=deregister)
        self.telemetry.stop(deregister=deregister)


class LiteFleet:
    """N lite replicas beaten by a handful of driver threads.

    Each driver owns a shard and paces one replica's beat every
    ``interval / shard_size`` seconds: a smooth, phase-spread heartbeat
    fan-in. Registration and deregistration also run shard-parallel.
    Beats that land mid-registry-restart count in ``beat_errors`` and
    retry on the next cycle; the row lease (2.5x interval) rides out a
    rolling restart's per-node downtime.
    """

    def __init__(self, registry_address: str, count: int, *, pool=None,
                 interval: float = 2.0, drivers: int = 8,
                 volume_keys: int = 0, metrics_endpoint: str = "",
                 seed: int = 0):
        self.interval = interval
        self.replicas = [
            LiteReplica(
                f"lite-{i:04d}", registry_address, pool=pool,
                interval=interval, volume_keys=volume_keys,
                metrics_endpoint=metrics_endpoint, seed=seed)
            for i in range(count)
        ]
        drivers = max(1, min(drivers, count or 1))
        self._shards = [self.replicas[i::drivers] for i in range(drivers)]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._err_lock = threading.Lock()
        self.beat_errors = 0

    def __len__(self) -> int:
        return len(self.replicas)

    def _each_shard(self, fn) -> None:
        threads = [
            threading.Thread(target=fn, args=(shard,), daemon=True)
            for shard in self._shards
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)

    def start(self) -> "LiteFleet":
        def boot(shard):
            for rep in shard:
                if self._stop.is_set():
                    return
                rep.register()

        self._each_shard(boot)
        for i, shard in enumerate(self._shards):
            t = threading.Thread(
                target=self._drive, args=(shard,),
                name=f"oim-lite-fleet-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _drive(self, shard) -> None:
        import grpc

        pace = self.interval / max(1, len(shard))
        i = 0
        while not self._stop.is_set():
            try:
                shard[i % len(shard)].beat()
            except grpc.RpcError:
                # Registry mid-restart / mid-election: the next cycle's
                # beat retries, the lease absorbs the gap.
                with self._err_lock:
                    self.beat_errors += 1
            i += 1
            if self._stop.wait(pace):
                return

    def beat_all(self) -> None:
        """One synchronous beat of every replica (shard-parallel): a
        deterministic fan-in burst, independent of pacing."""
        import grpc

        def sweep(shard):
            for rep in shard:
                try:
                    rep.beat()
                except grpc.RpcError:
                    with self._err_lock:
                        self.beat_errors += 1

        self._each_shard(sweep)

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads.clear()

        def drop(shard):
            for rep in shard:
                rep.stop(deregister=deregister)

        self._each_shard(drop)


class ClusterSim(EngineSim):
    """The parameterizable in-process cluster (see module docstring).

    Use as a context manager; ``start()``/``stop()`` for manual control.
    Component handles live in ``registries`` (list of (service, server,
    manager) tuples — manager None when unreplicated), ``controllers``
    and ``replicas``.
    """

    replica_class = ReplicaHandle

    def __init__(
        self,
        *,
        replicas: int = 2,
        registry_pair: bool = False,
        registry_quorum: int = 0,
        controllers: int = 0,
        primary_lease_s: float = 0.5,
        election_timeout_s: float = 0.4,
        heartbeat_s: float = 0.3,
        table_interval_s: float = 0.1,
        controller_delay_s: float = 0.2,
        max_batch: int = 2,
        max_seq: int = 64,
        queue_depth: int = 64,
        engine_kwargs: list[dict] | None = None,
        lite_replicas: int = 0,
        lite_interval_s: float = 2.0,
        lite_volume_keys: int = 0,
        lite_drivers: int = 8,
        device="cuda",
    ):
        from oim_tpu_torch.common.channelpool import ChannelPool

        super().__init__(replicas=replicas, max_batch=max_batch, max_seq=max_seq,
                         queue_depth=queue_depth, engine_kwargs=engine_kwargs,
                         device=device)
        self.registry_pair = registry_pair
        # N >= 3 raft-style members (registry/quorum.py) instead of the
        # pair; mutually exclusive with registry_pair.
        self.registry_quorum = registry_quorum
        self.n_controllers = controllers
        self.primary_lease_s = primary_lease_s
        self.election_timeout_s = election_timeout_s
        self.heartbeat_s = heartbeat_s
        self.table_interval_s = table_interval_s
        self.controller_delay = controller_delay_s
        # Decode-stubbed replicas (LiteReplica): real serve/telemetry
        # rows, no engines — the 1k-scale control-plane substrate.
        self.n_lite = lite_replicas
        self.lite_interval_s = lite_interval_s
        self.lite_volume_keys = lite_volume_keys
        self.lite_drivers = lite_drivers
        self.lite: LiteFleet | None = None
        self.pool = ChannelPool()
        self.registry_address = ""
        self.registries: list = []   # [(service, server, manager)]
        self.controllers: list[ControllerHandle] = []
        self.table = None
        self.router = None
        self._router_channel = None
        self.router_stub = None
        self._feeders: list = []
        self._watchers: list = []
        self._tmpfiles: list[str] = []
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        from oim_tpu_torch.common import tlsutil
        from oim_tpu_torch.registry import MemRegistryDB, RegistryService
        from oim_tpu_torch.registry.registry import registry_server
        from oim_tpu_torch.registry.replication import (
            PRIMARY,
            STANDBY,
            ReplicationManager,
        )
        from oim_tpu_torch.router import ReplicaTable, RouterService, router_server
        from oim_tpu_torch.spec import oim_pb2 as pb
        from oim_tpu_torch.spec.services import RegistryStub, ServeStub

        self._open()

        if self.registry_quorum:
            from oim_tpu_torch.registry.quorum import QuorumManager

            services, servers = [], []
            for _ in range(self.registry_quorum):
                svc = RegistryService(db=MemRegistryDB())
                srv = registry_server("tcp://localhost:0", svc)
                services.append(svc)
                servers.append(srv)
            addrs = [srv.addr for srv in servers]
            managers = []
            for i, svc in enumerate(services):
                managers.append(QuorumManager(
                    svc, node_id=addrs[i],
                    peers=[a for a in addrs if a != addrs[i]],
                    election_timeout_s=self.election_timeout_s,
                    # Past the election window: a partitioned majority
                    # elects BEFORE the minority leader's step-down —
                    # the deterministic heal-signature order.
                    stepdown_grace_s=3 * self.election_timeout_s))
            self.registries = list(zip(services, servers, managers))
            self.registry_address = ",".join(addrs)
            for mgr in managers:
                mgr.start()
            if not wait_for(lambda: self.registry_leader() is not None,
                            timeout=30):
                raise AssertionError("quorum never elected a leader")
        elif self.registry_pair:
            p_svc = RegistryService(db=MemRegistryDB())
            p_srv = registry_server("tcp://localhost:0", p_svc)
            s_svc = RegistryService(db=MemRegistryDB())
            s_srv = registry_server("tcp://localhost:0", s_svc)
            p_mgr = ReplicationManager(
                p_svc, peer=s_srv.addr, role=PRIMARY,
                primary_lease_seconds=self.primary_lease_s,
                boot_grace_seconds=5.0)
            s_mgr = ReplicationManager(
                s_svc, peer=p_srv.addr, role=STANDBY,
                primary_lease_seconds=self.primary_lease_s,
                boot_grace_seconds=5.0)
            self.registries = [(p_svc, p_srv, p_mgr), (s_svc, s_srv, s_mgr)]
            self.registry_address = f"{p_srv.addr},{s_srv.addr}"
            p_mgr.start(initial_probe=False)
            s_mgr.start(initial_probe=False)
            # The standby must have a complete snapshot before any rung
            # kills the primary (auto-promotion refuses without one) —
            # fail the SETUP here rather than misattribute it later as a
            # broken promotion heal path.
            if not wait_for(lambda: s_mgr._may_auto_promote(),
                            timeout=30):
                raise AssertionError(
                    "standby never completed its snapshot sync")
        else:
            svc = RegistryService(db=MemRegistryDB())
            srv = registry_server("tcp://localhost:0", svc)
            self.registries = [(svc, srv, None)]
            self.registry_address = srv.addr

        for i in range(self.n_controllers):
            self.controllers.append(ControllerHandle(self, f"host-{i}"))
        if self.controllers:
            stub = RegistryStub(self.pool.get(
                self.registries[0][1].addr, None, "component.registry"))

            def registered():
                rows = stub.GetValues(
                    pb.GetValuesRequest(path=""), timeout=10.0).values
                seen = {v.path.split("/")[0] for v in rows
                        if v.path.endswith("/address")}
                return len(seen) >= self.n_controllers

            if not wait_for(registered, timeout=15):
                raise AssertionError("controllers never registered")

        if self.n_lite:
            self.lite = LiteFleet(
                self.registry_address, self.n_lite, pool=self.pool,
                interval=self.lite_interval_s, drivers=self.lite_drivers,
                volume_keys=self.lite_volume_keys,
                metrics_endpoint=(
                    f"127.0.0.1:{self.metrics_srv.port}")).start()

        self._boot_replicas()

        if self.n_replicas:
            self.table = ReplicaTable(
                self.registry_address, interval=self.table_interval_s,
                pool=self.pool)
            self.table.refresh()
            if len(self.table) != self.n_replicas + self.n_lite:
                raise AssertionError(
                    f"routing table has {len(self.table)} of "
                    f"{self.n_replicas + self.n_lite} replicas")
            self.table.start()
            self.router = router_server(
                "tcp://127.0.0.1:0",
                RouterService(self.table, pool=self.pool))
            self._router_channel = tlsutil.dial(self.router.addr, None)
            self.router_stub = ServeStub(self._router_channel)
        self._started = True

    def stop(self) -> None:
        for watcher in self._watchers:
            watcher.stop()
        self._watchers.clear()
        self._feeders.clear()  # feeders ride the sim's pool; no close
        if self._router_channel is not None:
            self._router_channel.close()
        if self.router is not None:
            self.router.force_stop()
        if self.table is not None:
            self.table.stop()
        self._stop_replicas()
        if self.lite is not None:
            self.lite.stop()
            self.lite = None
        for handle in self.controllers:
            handle.shutdown()
        for _, server, manager in self.registries:
            if manager is not None:
                try:
                    manager.stop()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            server.force_stop()
        self.pool.close()
        for path in self._tmpfiles:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._close()

    # -- registry faults ---------------------------------------------------

    def kill_registry_primary(self):
        """SIGKILL the current PRIMARY registry node (pair mode): its
        server and replication threads die; the standby's watchdog
        auto-promotes after the primary lease lapses. Returns the killed
        node's (service, server, manager) tuple."""
        from oim_tpu_torch.registry.replication import PRIMARY

        for node in self.registries:
            svc, server, manager = node
            if manager is not None and manager.role == PRIMARY:
                manager.stop()
                server.force_stop()
                return node
        raise AssertionError("no live PRIMARY registry to kill")

    # -- quorum faults -----------------------------------------------------

    def registry_leader(self):
        """The current LEADER's (service, server, manager) tuple, or None
        while an election is in flight (quorum mode)."""
        from oim_tpu_torch.registry.quorum import LEADER

        for node in self.registries:
            if node[2] is not None and node[2].role == LEADER:
                return node
        return None

    def kill_registry_leader(self):
        """SIGKILL the quorum LEADER: threads and listener die mid-term,
        nothing steps down gracefully — the surviving majority must elect
        on its own. Returns the killed node."""
        node = self.registry_leader()
        if node is None:
            raise AssertionError("no live LEADER registry to kill")
        _, server, manager = node
        manager.stop()
        server.force_stop()
        return node

    def partition_registry(self, minority_ids) -> None:
        """Symmetric partition of the quorum by member id (address):
        members in ``minority_ids`` and the rest cannot exchange any
        registry-to-registry traffic in either direction. Client traffic
        is NOT cut — the point is what each side ANSWERS."""
        minority = set(minority_ids)
        member_ids = [m.node_id for _, _, m in self.registries
                      if m is not None]
        for _, _, manager in self.registries:
            if manager is None:
                continue
            if manager.node_id in minority:
                manager.set_unreachable(
                    [a for a in member_ids if a not in minority])
            else:
                manager.set_unreachable(minority)

    def heal_registry_partition(self) -> None:
        for _, _, manager in self.registries:
            if manager is not None:
                manager.set_unreachable([])

    def restart_registry_node(self, index: int) -> None:
        """Restart quorum member ``index`` in place: SIGKILL (threads +
        listener), then a FRESH process-equivalent — empty DB, term 0 —
        on the SAME address. The rejoin must resync by snapshot."""
        from oim_tpu_torch.registry import MemRegistryDB, RegistryService
        from oim_tpu_torch.registry.quorum import QuorumManager
        from oim_tpu_torch.registry.registry import registry_server

        _, old_server, old_manager = self.registries[index]
        addr = old_server.addr
        old_manager.stop()
        old_server.force_stop()
        peers = [m.node_id for i, (_, _, m) in enumerate(self.registries)
                 if i != index and m is not None]
        svc = RegistryService(db=MemRegistryDB())
        srv = registry_server(f"tcp://{addr}", svc)
        mgr = QuorumManager(svc, node_id=addr, peers=peers,
                            election_timeout_s=self.election_timeout_s,
                            stepdown_grace_s=3 * self.election_timeout_s)
        mgr.start()
        self.registries[index] = (svc, srv, mgr)

    def registry_write(self, path: str, value: str,
                       lease_seconds: float = 0.0) -> bool:
        """One admin SetValue, rotating across every registry endpoint
        (the oimctl failover shape). True when some member accepted —
        i.e. a leader exists and committed it."""
        import grpc

        from oim_tpu_torch.spec import oim_pb2 as pb
        from oim_tpu_torch.spec.services import RegistryStub

        for _, server, manager in self.registries:
            if manager is not None and not manager._threads:
                continue  # killed node: don't hang on its corpse
            try:
                RegistryStub(self.pool.get(
                    server.addr, None, "component.registry")).SetValue(
                    pb.SetValueRequest(value=pb.Value(
                        path=path, value=value,
                        lease_seconds=lease_seconds)),
                    timeout=5.0)
                return True
            except grpc.RpcError:
                continue
        return False

    def registry_watcher(self, prefix: str = "") -> _SimWatcher:
        """A push-fed view of the registry under ``prefix``, riding one
        Watch stream with endpoint failover — how a rung proves a stream
        SURVIVES kills, partitions and rolling restarts."""
        watcher = _SimWatcher(self, prefix)
        self._watchers.append(watcher)
        return watcher

    # -- feeder ------------------------------------------------------------

    def feeder(self, controller_id: str = "host-0", **kwargs):
        from oim_tpu_torch.feeder import Feeder

        feeder = Feeder(registry_address=self.registry_address,
                        controller_id=controller_id, pool=self.pool,
                        **kwargs)
        self._feeders.append(feeder)
        return feeder

    def tmpfile(self, data: bytes) -> str:
        f = tempfile.NamedTemporaryFile(
            prefix="oim-chaos-", suffix=".bin", delete=False)
        f.write(data)
        f.close()
        self._tmpfiles.append(f.name)
        return f.name

    # -- client load -------------------------------------------------------

    def routed_load(self, reqs, concurrency: int = 2, timeout: float = 120.0):
        """Drive ``reqs`` = [(prompt, n_new, temp, seed), ...] through the
        router from ``concurrency`` worker threads. Returns (results,
        errors): results[i] is the token list or None when request i
        failed."""
        from oim_tpu_torch.spec import oim_pb2 as pb

        results: list[list[int] | None] = [None] * len(reqs)
        errors: list[Exception] = []
        lock = threading.Lock()
        work = list(range(len(reqs)))

        def worker():
            while True:
                with lock:
                    if not work:
                        return
                    i = work.pop(0)
                prompt, n_new, temp, seed = reqs[i]
                try:
                    toks: list[int] = []
                    for delta in self.router_stub.Generate(
                            pb.GenerateRequest(
                                prompt=prompt, max_new_tokens=n_new,
                                temperature=temp, seed=seed),
                            timeout=timeout):
                        toks.extend(delta.tokens)
                    with lock:
                        results[i] = toks
                except Exception as err:  # noqa: BLE001 - tallied
                    with lock:
                        errors.append(err)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, concurrency))]
        deadline = time.monotonic() + timeout
        for t in threads:
            t.start()
        for t in threads:
            # One SHARED deadline: sequential full-timeout joins would
            # stretch worst-case detection to concurrency x timeout.
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = sum(1 for t in threads if t.is_alive())
        if hung:
            # A wedged stream is exactly the failure class the ladder
            # exists to catch — it must surface as an error, never pass a
            # zero-error assertion vacuously (results stay None and
            # assert_byte_identity skips None).
            with lock:
                errors.append(TimeoutError(
                    f"{hung} load worker(s) hung past {timeout}s; "
                    f"unfinished requests: "
                    f"{[i for i, r in enumerate(results) if r is None]}"))
        return results, errors

    # -- invariants --------------------------------------------------------

    def _census(self) -> tuple[dict, list[str]]:
        """The engines' census plus a bounded channel pool: every pooled
        channel must belong to a known target (registry nodes, replicas,
        controllers) — nothing dangling."""
        census, leaks = super()._census()
        census["pooled_channels"] = len(self.pool)
        known = {server.addr for _, server, _ in self.registries}
        known |= {h.server.addr for h in self.replicas
                  if h.server is not None}
        known |= {h.server.addr for h in self.controllers}
        strays = [t for t in self.pool.targets() if t not in known]
        if strays:
            leaks.append(f"channels pooled to unknown targets: {strays}")
        return census, leaks
