"""The port's operator CLI (``oim_tpu_torch/cli/oimctl.py``) and its last
helpers (``common/ca.py``, ``common/cmdmonitor.py``) held against
``oim_tpu``'s on the CPU.

* Each file equals JAX's source once ``oim_tpu.`` reads ``oim_tpu_torch.``,
  but for the lines listed below by content, each with its reason.
* One static fleet state: rows written into a registry (controllers,
  serve rows, telemetry rows, alerts, the autoscaler's fleet row; some
  leases lapsed on an injected clock), and a local HTTP server with a
  fixed ``/metrics`` text and a fixed ``/debug/events`` ring. Over it,
  JAX's ``oimctl.main`` and the port's print the same bytes for ``--get``
  (with and without ``--stale``), ``--health``, ``--top``, ``--alerts``,
  ``--metrics`` and ``--events`` (with ``--trace`` and ``--type``). Each
  registry command runs each CLI against a port registry and a JAX one
  (the cross-wire), and all four prints must be equal. Masked: the
  ``for=`` column of ``--alerts``, an age read off the wall clock.
* ``--promote`` finds and promotes the standby of a port primary/standby
  pair, from either CLI.
* ``--top --watch`` renders one refresh from the port registry's Watch
  streams, and the test waits until every stream has ended.
* ``--autopsy`` walks a port ``oim-serve`` (``ServeService`` in process,
  llama-tiny on the CPU) found through its telemetry row, and attributes
  more than 0.9 of the request's wall time; JAX's CLI prints the same.
* A fresh interpreter runs the port's ``--metrics`` and ``--events``
  against a port ``MetricsServer`` without loading grpc or protobuf (the
  card machine has neither).
"""

from __future__ import annotations

import contextlib
import difflib
import http.server
import io
import json
import re
import subprocess
import sys
import threading
import time
import urllib.parse
from collections import Counter
from pathlib import Path

import pytest
import torch

from oim_tpu.cli import oimctl as joimctl
from oim_tpu.common import logging as jlogging
from oim_tpu.registry import MemRegistryDB as JMemRegistryDB
from oim_tpu.registry import RegistryService as JRegistryService
from oim_tpu.registry.leases import LeaseTable as JLeaseTable
from oim_tpu.registry.registry import registry_server as jregistry_server
from oim_tpu_torch.cli import oimctl
from oim_tpu_torch.common import events
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common import tlsutil
from oim_tpu_torch.common import tracing
from oim_tpu_torch.models import llama
from oim_tpu_torch.registry import MemRegistryDB, RegistryService
from oim_tpu_torch.registry.leases import LeaseTable
from oim_tpu_torch.registry.registry import registry_server
from oim_tpu_torch.registry.replication import PRIMARY, STANDBY, ReplicationManager
from oim_tpu_torch.serve import ServeEngine
from oim_tpu_torch.serve import service as tservice
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub, ServeStub

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parent.parent

_WIRE = ("grpc, the stubs and the channel pool load where the registry is dialed, so "
         "--metrics, --events and the scrape-side helpers run on the card, which has no "
         "grpcio")
_SPEC = ("the port's spec package holds the params dataclasses; the wire is spec.oim_pb2 "
         "and spec.services")
_PB = "    from oim_tpu_torch.spec import oim_pb2 as pb"
_BLANK = "a blank line that sets a moved import apart, as the package's style does"

# file -> [(JAX's line after the prefix rewrite, or None; the port's line,
#           or None; why)]
LISTED: dict[str, list[tuple[str | None, str | None, str]]] = {
    "cli/oimctl.py": [
        ("import grpc", None, _WIRE),
        ("from oim_tpu_torch.common import channelpool", None, _WIRE),
        ("from oim_tpu_torch.common.endpoints import FAILOVER_CODES, RegistryEndpoints", None,
         _WIRE),
        ("from oim_tpu_torch.spec import RegistryStub, pb", None, _WIRE),
        (None, "from typing import TYPE_CHECKING",
         "names RegistryStub for the annotations without loading grpc"),
        (None, "# grpc, the stubs and the channel pool load where the registry is dialed:",
         _WIRE),
        (None, "# --metrics, --events and the scrape-side helpers run without grpcio.", _WIRE),
        (None, "if TYPE_CHECKING:", "names RegistryStub for the annotations without loading "
         "grpc"),
        (None, "    from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
        # health_rows, serve_health_rows, registry_health_row, telemetry_rows,
        # fleet_rows and alert_rows build their requests from pb.
        *[(None, _PB, _WIRE)] * 6,
        ("", None, _BLANK),
        *[(None, "", _BLANK)] * 6,
        (None, "    " + _PB, _WIRE),  # _PrefixWatch._consume
        (None, "        import grpc", _WIRE),  # _PrefixWatch._loop's except clause
        (None, "    import grpc", _WIRE),  # main, past the --metrics/--events return
        (None, "    from oim_tpu_torch.common import channelpool", _WIRE),
        (None, "    from oim_tpu_torch.common.endpoints import FAILOVER_CODES, "
         "RegistryEndpoints", _WIRE),
        (None, _PB, _WIRE),
        (None, "    from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
    ],
    "common/ca.py": [],
    "common/cmdmonitor.py": [],
}


def _same_as_jax(rel: str, listed: list) -> None:
    jax_lines = (_ROOT / "oim_tpu" / rel).read_text().replace(
        "oim_tpu.", "oim_tpu_torch.").splitlines()
    port_lines = (_ROOT / "oim_tpu_torch" / rel).read_text().splitlines()
    removed, added = Counter(), Counter()
    ops = difflib.SequenceMatcher(None, jax_lines, port_lines, autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in ops:
        if tag != "equal":
            removed.update(jax_lines[i1:i2])
            added.update(port_lines[j1:j2])
    assert removed == Counter(j for j, _, _ in listed if j is not None)
    assert added == Counter(p for _, p, _ in listed if p is not None)


@pytest.mark.parametrize("rel", sorted(LISTED))
def test_copy_equals_jax_source_but_the_listed_lines(rel):
    _same_as_jax(rel, LISTED[rel])


def test_every_listed_line_carries_a_reason():
    for rel, listed in LISTED.items():
        for jax_line, port_line, why in listed:
            assert (jax_line is not None or port_line is not None) and why.strip(), rel


@pytest.fixture(autouse=True)
def restore_loggers():
    """``main`` installs each package's global logger from its flags: put
    the previous ones back."""
    jprev = jlogging.set_global(jlogging.Logger(level=jlogging.ERROR))
    tprev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    jlogging.set_global(jprev)
    tlogging.set_global(tprev)


def wait_for(predicate, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def run(mod, argv: list[str]) -> str:
    """``mod.main(argv)``'s standard output; ``main`` must return 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main([*argv, "--log-level", "error"]) == 0
    return out.getvalue()


# ----------------------------------------------------------- the state ----


def fixed_metrics() -> str:
    """A daemon's scrape with every family ``--top`` reads, rendered once
    from a private registry with exemplars (the OpenMetrics form both CLIs
    ask for), plus a label value that needs unescaping."""
    reg = M.Registry()
    reg.gauge("oim_serve_qps", "requests finished per second").set(2.5)
    role = reg.gauge("oim_serve_role", "disaggregation role", labelnames=("role",))
    for name, v in (("prefill", 1), ("decode", 0), ("mixed", 0)):
        role.labels(role=name).set(v)
    lat = reg.histogram("oim_serve_token_latency_seconds", "token latency",
                        labelnames=("kind",), buckets=(0.01, 0.05, 0.1, 0.5, 1.0))
    for i, v in enumerate((0.004, 0.03, 0.07, 0.2, 0.3, 0.8, 2.0)):
        lat.labels(kind="first").observe(v, f"{i:032x}")
    for v in (0.002, 0.004, 0.02, 0.03, 0.04):
        lat.labels(kind="next").observe(v)
    reg.gauge("oim_serve_queue_depth", "queued").set(3)
    reg.gauge("oim_serve_slot_occupancy", "occupancy").set(0.75)
    reg.counter("oim_serve_prefix_hits_total", "hits").inc(3)
    reg.counter("oim_serve_prefix_misses_total", "misses").inc(9)
    reg.gauge("oim_serve_kv_pages_total", "pages").set(256)
    reg.gauge("oim_serve_kv_pages_used", "pages used").set(40)
    reg.gauge("oim_kvtier_hbm_pages", "hbm pages").set(12)
    reg.gauge("oim_kvtier_host_pages", "host pages").set(30)
    peer = reg.counter("oim_serve_prefix_peer_fetches_total", "peer fetches",
                       labelnames=("outcome",))
    peer.labels(outcome="hit").inc(2)
    peer.labels(outcome="miss").inc(1)
    reg.counter("oim_serve_spec_proposed_tokens_total", "proposed").inc(100)
    reg.counter("oim_serve_spec_accepted_tokens_total", "accepted").inc(70)
    reg.gauge("oim_serve_spec_accept_rolling", "rolling").set(0.65)
    members = reg.gauge("oim_serve_shard_members", "members", labelnames=("state",))
    members.labels(state="ready").set(1)
    members.labels(state="stale").set(1)
    reg.counter("oim_stage_cache_hits_total", "hits").inc(5)
    reg.counter("oim_stage_cache_misses_total", "misses").inc(15)
    reg.gauge("oim_replication_lag_records", "lag").set(4)
    commit = reg.histogram("oim_registry_commit_seconds", "commit", labelnames=("phase",),
                           buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.002, 0.004, 0.05):
        commit.labels(phase="total").observe(v)
    pick = reg.histogram("oim_router_pick_seconds", "pick", buckets=(0.0001, 0.001, 0.01))
    for v in (0.00005, 0.0002, 0.0004):
        pick.observe(v)
    routed = reg.counter("oim_router_requests_total", "routed", labelnames=("replica",))
    for rid, n in (("r0", 4), ("r1", 2), ("r2", 0)):
        routed.labels(replica=rid).inc(n)
    reg.gauge("oim_test_escaped", "label escapes", labelnames=("path",)).labels(
        path='a"b\\c\nd').set(float("nan"))
    return reg.render(exemplars=True) + "# EOF\n"


TRACE_A, TRACE_B = "a1" * 16, "b2" * 16


def fixed_events() -> events.EventRecorder:
    rec = events.EventRecorder(64)
    rec.emit(events.ROUTER_RETRY, trace_id=TRACE_A, replica="r1", code="UNAVAILABLE")
    rec.emit(events.SLOT_EVICTED, trace_id=TRACE_A, slot=0, reason="cancelled", tokens=8)
    rec.emit(events.LEASE_EXPIRED, trace_id="", path="host-1/address")
    rec.emit(events.SLOT_EVICTED, trace_id=TRACE_B, slot=1, reason="preempted", tokens=3)
    rec.emit(events.REPLICA_DRAIN, trace_id="", replica="r2")
    return rec


class Daemon:
    """A local HTTP server answering as a daemon's metrics endpoint: the
    fixed scrape on ``/metrics`` and the fixed ring on ``/debug/events``,
    filtered as ``MetricsServer`` filters it."""

    def __init__(self):
        text, ring = fixed_metrics().encode(), fixed_events()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                parsed = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(parsed.query))
                if parsed.path == "/metrics":
                    body = text
                elif parsed.path == "/debug/events":
                    body = ring.to_json(trace_id=query.get("trace", ""),
                                        type_=query.get("type", ""),
                                        limit=int(query.get("limit", 0))).encode()
                elif parsed.path == "/debug/spans":
                    body = b'{"traceEvents": []}'
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.target = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _snapshot(values) -> dict:
    reg = M.Registry()
    h = reg.histogram("x", buckets=(0.01, 0.05, 0.1, 0.5, 1.0))
    for v in values:
        h.observe(v)
    return h._solo().snapshot()


def fleet_rows(target: str) -> list[tuple[str, dict | str, float]]:
    """(path, body, lease seconds): LIVE rows lease 1000 s, STALE ones 5 s
    (the clock then moves 10 s), 0 = permanent."""
    hist = {"first_token": _snapshot((0.004, 0.03, 0.07, 0.2)),
            "inter_token": _snapshot((0.002, 0.02))}
    slow = {"first_token": _snapshot((0.3, 0.8, 0.9)), "inter_token": _snapshot((0.04,))}
    return [
        ("host-0/address", "127.0.0.1:9422", 1000.0),
        ("host-0/mesh", "1,2,0", 0.0),
        ("host-1/address", "127.0.0.1:9423", 5.0),
        ("host-1/mesh", "0,0,0", 0.0),
        ("serve/r0", {"endpoint": "127.0.0.1:9460", "free_slots": 2, "max_batch": 8,
                      "queue_depth": 1, "ready": True}, 1000.0),
        ("serve/r0.member.1", {"member": 1, "shard": 2, "state": "ready"}, 1000.0),
        ("serve/r1", {"endpoint": "127.0.0.1:9461", "free_slots": 0, "max_batch": 8,
                      "queue_depth": 4, "ready": False}, 5.0),
        ("serve/r2", "not json", 1000.0),
        ("telemetry/r0", {"role": "serve", "metrics": target, "hist": hist, "beat": 7},
         1000.0),
        ("telemetry/r1", {"role": "serve", "metrics": target, "hist": slow, "beat": 3},
         1000.0),
        ("telemetry/r9", {"role": "serve", "metrics": target, "beat": 1}, 5.0),
        ("telemetry/registry-a", {"role": "registry", "metrics": target, "beat": 2}, 1000.0),
        ("telemetry/router-a", {"role": "router", "metrics": target, "beat": 2}, 1000.0),
        ("telemetry/gone", {"role": "serve", "metrics": "127.0.0.1:9", "beat": 2}, 1000.0),
        ("alert/first_token_p99", {"kind": "latency", "objective": 0.99, "threshold_s": 0.5,
                                   "direction": "up", "burn_fast": 14.2, "burn_slow": 3.1,
                                   "threshold": 10.0, "since": time.time() - 30}, 1000.0),
        ("alert/errors", {"kind": "ratio", "direction": "up", "burn_fast": 20.0,
                          "burn_slow": 11.5, "threshold": 10.0}, 1000.0),
        ("alert/old", {"kind": "ratio"}, 5.0),
        ("fleet/autoscaler", {"autoscaler": "as-a", "desired": 3, "ready": 2, "min": 1,
                              "max": 4, "version": "v2", "alerts": ["first_token_p99"]},
         1000.0),
    ]


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


class Registry:
    """One package's registry on port 0 over an injected lease clock, with
    Watch keepalives each 20 ms so a stopped stream ends within one."""

    def __init__(self, pkg: str):
        db, svc, leases, serve = (
            (MemRegistryDB, RegistryService, LeaseTable, registry_server) if pkg == "port"
            else (JMemRegistryDB, JRegistryService, JLeaseTable, jregistry_server))
        self.clock = Clock()
        self.service = svc(db=db(), leases=leases(clock=self.clock))
        self.service.watch.keepalive = 0.02
        self.server = serve("tcp://127.0.0.1:0", self.service)
        self.addr = self.server.addr

    def write(self, rows) -> None:
        with tlsutil.dial(self.addr, None) as channel:
            stub = RegistryStub(channel)
            for path, body, lease in rows:
                value = body if isinstance(body, str) else json.dumps(body)
                stub.SetValue(pb.SetValueRequest(value=pb.Value(
                    path=path, value=value, lease_seconds=lease)), timeout=10)

    def close(self) -> None:
        assert wait_for(lambda: not self.service.watch._streams, 5)
        self.server.stop()


@pytest.fixture(scope="module")
def fleet():
    daemon = Daemon()
    rows = fleet_rows(daemon.target)
    regs = {pkg: Registry(pkg) for pkg in ("port", "jax")}
    for reg in regs.values():
        reg.write(rows)
        reg.clock.now += 10.0  # the 5 s leases lapse
    yield daemon, regs
    for reg in regs.values():
        reg.close()
    daemon.close()


CLIS = {"port": oimctl, "jax": joimctl}


def mask(command: str, text: str) -> str:
    """--alerts prints how long each alert has fired (``for=``), an age
    read off the wall clock at the call."""
    if command == "alerts":
        return re.sub(r"for=\d+s", "for=<age>", text)
    return text


REGISTRY_COMMANDS = {
    "get": ["--get", ""],
    "get_stale": ["--get", "", "--stale"],
    "get_prefix": ["--get", "serve"],
    "health": ["--health"],
    "top": ["--top"],
    "top_limit": ["--top", "--limit", "2"],
    "alerts": ["--alerts"],
}


@pytest.mark.parametrize("command", sorted(REGISTRY_COMMANDS))
def test_registry_commands_print_jax_bytes_across_the_packages(fleet, command):
    """Each CLI against each package's registry: four equal prints."""
    _, regs = fleet
    outs = {(cli, reg): mask(command, run(CLIS[cli], [
        "--registry", regs[reg].addr, *REGISTRY_COMMANDS[command]]))
        for cli in CLIS for reg in regs}
    assert len(set(outs.values())) == 1, outs
    out = outs[("port", "port")]
    expect = {
        "get": ["host-0/address=127.0.0.1:9422", "serve/r2=not json"],
        "get_stale": ["host-1/address=127.0.0.1:9423", "alert/old="],
        "get_prefix": ["serve/r0.member.1="],
        "health": ["host-0\tALIVE\t127.0.0.1:9422\t1,2,0",
                   "host-1\tSTALE\t127.0.0.1:9423\t0,0,0",
                   "serve/r0\tALIVE\t127.0.0.1:9460\tfree=2/8 queue=1 ready=true",
                   "serve/r0.member.1\tALIVE\t-\tmember=1/2 state=ready",
                   "serve/r1\tSTALE", "serve/r2\tALIVE\t?\tfree=?/? queue=? ready=false"],
        "top": ["FLEET  leader=as-a  desired=3  ready=2  min=1  max=4  version=v2  "
                "alerts=first_token_p99", "*** FIRING: errors, first_token_p99",
                "r9 ", "STALE", "UNSCRAPEABLE", "prefill", "registry", "router"],
        "top_limit": ["ALL "],
        "alerts": ["first_token_p99\tFIRING\tdir=up\tburn_fast=14.2", "for=<age>",
                   "target p99<=500ms", "errors\tFIRING"],
    }[command]
    for want in expect:
        assert want in out, (want, out)
    if command == "get":
        assert "host-1/address" not in out and "alert/old" not in out
    if command == "top_limit":
        # ALL plus the two worst rows by first-token p99: r1, then r0.
        body = out.splitlines()[3:]
        assert [line.split()[0] for line in body] == ["ALL", "r1", "r0"], out


SCRAPE_COMMANDS = {
    "metrics": lambda t: ["--metrics", t],
    "events": lambda t: ["--events", t],
    "events_trace": lambda t: ["--events", t, "--trace", TRACE_A],
    "events_type": lambda t: ["--events", t, "--type", events.SLOT_EVICTED],
    "events_trace_type": lambda t: ["--events", t, "--trace", TRACE_B, "--type",
                                    events.SLOT_EVICTED],
    "events_none": lambda t: ["--events", t, "--trace", "c3" * 16],
}


@pytest.mark.parametrize("command", sorted(SCRAPE_COMMANDS))
def test_scrape_commands_print_jax_bytes(fleet, command):
    daemon, _ = fleet
    argv = SCRAPE_COMMANDS[command](daemon.target)
    out = run(oimctl, argv)
    assert out == run(joimctl, argv)
    lines = out.splitlines()
    if command == "metrics":
        assert '  {kind="first"} count=7 mean=0.486286s p50~0.2s p99~1s' in lines, out
        assert '  {path="a\"b\\c\nd"} nan' in out
        assert "oim_router_requests_total [counter] — routed" in lines
    elif command == "events":
        assert [line.split("\t")[1] for line in lines] == [
            "router_retry", "slot_evicted", "lease_expired", "slot_evicted", "replica_drain"]
    elif command == "events_trace":
        assert [line.split("\t")[1:3] for line in lines] == [
            ["router_retry", TRACE_A], ["slot_evicted", TRACE_A]]
    elif command == "events_type":
        assert [line.split("\t")[2] for line in lines] == [TRACE_A, TRACE_B]
    elif command == "events_trace_type":
        assert len(lines) == 1 and "reason=preempted" in lines[0]
    else:
        assert lines == [f"no recorded events for trace {'c3' * 16} (0 dropped from the ring)"]


def test_top_watch_renders_one_refresh_from_the_ports_watch_streams(fleet, monkeypatch):
    """``--top --watch`` rides the Watch streams of the port registry (only
    the live rows: a Watch snapshot holds no lapsed lease); the refresh
    after the first ends the session, and every stream ends before the
    test does."""
    _, regs = fleet
    period = 0.0625
    real_sleep = time.sleep

    def sleep(seconds):
        if seconds == period and threading.current_thread() is threading.main_thread():
            raise KeyboardInterrupt
        real_sleep(seconds)

    monkeypatch.setattr(time, "sleep", sleep)
    hub = regs["port"].service.watch
    outs = {}
    for cli in CLIS:
        outs[cli] = run(CLIS[cli], ["--registry", regs["port"].addr, "--top", "--watch",
                                    str(period)])
        assert wait_for(lambda: not hub._streams, 5), f"{cli}: Watch streams still open"
    assert outs["port"] == outs["jax"]
    out = outs["port"]
    assert out.startswith("\033[2J\033[H") and "*** FIRING: errors, first_token_p99" in out
    ids = [line.split()[0] for line in out.splitlines()[3:]]
    assert sorted(ids) == ["ALL", "gone", "r0", "r1", "registry-a", "router-a"]


# ------------------------------------------------------------- promote ----


class Node:
    """One half of a port primary/standby pair, promoted by hand only."""

    def __init__(self, role: str):
        self.service = RegistryService(db=MemRegistryDB())
        self.server = registry_server("tcp://127.0.0.1:0", self.service)
        self.role = role
        self.manager = None

    def start(self, peer: str) -> None:
        self.manager = ReplicationManager(self.service, peer=peer, role=self.role,
                                          primary_lease_seconds=0)
        self.manager.start(initial_probe=False)

    def kill(self) -> None:
        if self.manager is not None:
            self.manager.stop()
        self.server.force_stop()


@pytest.fixture
def pair():
    primary, standby = Node(PRIMARY), Node(STANDBY)
    primary.start(standby.server.addr)
    standby.start(primary.server.addr)
    yield primary, standby
    for node in (primary, standby):
        node.kill()


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_promote_finds_the_standby_of_a_port_pair(pair, cli):
    primary, standby = pair
    endpoints = f"{primary.server.addr},{standby.server.addr}"
    out = run(CLIS[cli], ["--registry", endpoints, "--promote", "--set",
                          "host-0/address=127.0.0.1:1", "--get", "host-0"])
    assert out == f"promoted {standby.server.addr}\nhost-0/address=127.0.0.1:1\n"
    assert standby.manager.role == PRIMARY
    assert standby.service.db.get("host-0/address") == "127.0.0.1:1"
    health = run(CLIS[cli], ["--registry", standby.server.addr, "--health"])
    assert health.startswith("_registry\tPRIMARY\tepoch=")


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_promote_without_a_standby_fails_as_jax_does(pair, cli):
    primary, standby = pair
    standby.kill()
    with pytest.raises(SystemExit, match="no STANDBY among the endpoints"):
        CLIS[cli].main(["--registry", primary.server.addr, "--promote"])
    assert primary.manager.role == PRIMARY


# ------------------------------------------------------------- autopsy ----


def test_autopsy_over_a_port_oim_serve(fleet):
    """A Generate through the port's ServeService; the trace's spans and
    events are found through the replica's telemetry row and attributed
    above 0.9 of the wall time, by either CLI."""
    _, regs = fleet
    cfg = llama.tiny()
    engine = ServeEngine(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                         cfg, device="cpu", max_batch=2, max_seq=96, queue_depth=4)
    server = tservice.serve_server("tcp://127.0.0.1:0", tservice.ServeService(engine))
    metrics = M.MetricsServer(port=0).start()
    reg = Registry("port")
    try:
        reg.write([("telemetry/autopsy-r0", {"role": "serve",
                                             "metrics": f"127.0.0.1:{metrics.port}"}, 60.0)])
        with tlsutil.dial(server.addr, None) as channel:
            deltas = list(ServeStub(channel).Generate(
                pb.GenerateRequest(prompt=list(range(1, 25)), max_new_tokens=24),
                timeout=60))
        assert sum(len(d.tokens) for d in deltas) == 24
        [root] = [s for s in tracing.recorder().spans() if s.name == "serve.generate"
                  and s.attrs.get("prompt_tokens") == 24][-1:]
        outs = {cli: run(CLIS[cli], ["--registry", reg.addr, "--autopsy", root.trace_id])
                for cli in CLIS}
    finally:
        reg.close()
        metrics.stop()
        server.stop()
        engine.stop(drain=False, timeout=30)
    assert outs["port"] == outs["jax"]
    head = outs["port"].splitlines()[0]
    assert head.startswith(f"autopsy {root.trace_id}  root=serve.generate")
    coverage = float(re.search(r"attributed=([\d.]+)%", head).group(1)) / 100
    assert coverage > 0.9, outs["port"]
    for phase in ("admission queue", "prefill", "decode"):
        assert phase in outs["port"]


# ------------------------------------------------------ the card's half ----


def test_metrics_and_events_load_no_grpc_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "from oim_tpu_torch.cli import oimctl\n"
        "from oim_tpu_torch.common import events, metrics as M\n"
        "srv = M.MetricsServer(port=0).start()\n"
        "M.SERVE_TOKEN_LATENCY.labels(kind='first').observe(0.02, 'ab' * 16)\n"
        "events.emit(events.REPLICA_DRAIN, trace_id='ab' * 16, replica='r0')\n"
        "target = f'127.0.0.1:{srv.port}'\n"
        "assert oimctl.main(['--metrics', target, '--log-level', 'error']) == 0\n"
        "assert oimctl.main(['--events', target, '--trace', 'ab' * 16,\n"
        "                    '--log-level', 'error']) == 0\n"
        "srv.stop()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('grpc', 'jax', 'oim_tpu', 'cryptography')\n"
        "             or m.startswith('google.protobuf')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "[]"
    assert '  {kind="first"} count=1 mean=0.02s p50~0.0175s p99~0.02485s' in lines
    assert any(line.split("\t")[1:3] == ["replica_drain", "ab" * 16] for line in lines)
