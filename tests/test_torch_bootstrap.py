"""The port's registry bootstrap (``oim_tpu_torch/parallel/bootstrap.py``)
held against the JAX package's.

* ``derive_process_layout`` gives JAX's (coordinator, n, rank), or its
  error, over seeded random registry snapshots: unset coordinate
  components, ties broken by id, rows that are not controllers'.
* ``wait_for_hosts`` against a JAX ``RegistryService`` in process gives
  JAX's entries through a registry restart with a redial to the standby,
  and JAX's two timeout messages.
* ``initialize_from_registry`` as JAX's: a registry of one host joins no
  group, a registry of more hosts than ``expected_hosts`` joins them all;
  torchrun's local ranks (several processes a host) take consecutive
  ranks after their host's, in a real four-process gloo group too.
* Two gloo processes on the CPU joined by the trainer CLI (``--registry
  --expected-hosts 2 --coordinator-port``), each with its own port
  controller: the ranks come from the coordinates (host-1 at 0,0,0 is
  rank 0); a token volume staged over ``data=2`` is read by each rank
  for its rows only (half the volume's bytes); the trainer CLI then runs
  on the same group, fed through the registry. Both runs' losses equal
  JAX's one-process Trainer at the same global batch within 2e-5.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from oim_tpu.parallel import bootstrap as jboot
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.spec import RegistryStub as JRegistryStub
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.common.tlsutil import dial
from oim_tpu_torch.parallel import bootstrap as tboot
from oim_tpu_torch.spec.services import RegistryStub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def snapshot(seed: int) -> tuple[dict, str]:
    """A registry snapshot of 1-6 controllers (some without a mesh row,
    coordinates with unset components and ties) plus unrelated rows, and
    the id to derive for (sometimes one that is not registered)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    ids = [f"host-{int(i)}" for i in rng.choice(40, n, replace=False)]
    entries = {}
    for h in ids:
        a, b, port = (int(rng.integers(0, 9)), int(rng.integers(1, 250)),
                      int(rng.integers(1000, 9000)))
        entries[f"{h}/address"] = f"10.0.{a}.{b}:{port}"
        if rng.random() < 0.85:
            comps = [("*" if rng.random() < 0.2 else str(int(rng.integers(0, 3))))
                     for _ in range(3)]
            if rng.random() < 0.3:
                comps.append(str(int(rng.integers(0, 2))))
            entries[f"{h}/mesh"] = ",".join(comps)
    entries["telemetry/x.trainer"] = "127.0.0.1:1|trainer"
    entries["serve/r0/address"] = "127.0.0.1:2"
    who = ids[int(rng.integers(0, n))] if rng.random() < 0.9 else "host-99"
    return entries, who


@pytest.mark.parametrize("seed", range(40))
def test_derive_process_layout_matches_jax(seed):
    entries, who = snapshot(seed)
    port = 8476 + seed
    try:
        want = jboot.derive_process_layout(entries, who, port)
    except jboot.BootstrapError as e:
        with pytest.raises(tboot.BootstrapError) as got:
            tboot.derive_process_layout(entries, who, port)
        assert str(got.value) == str(e)
        return
    assert tboot.derive_process_layout(entries, who, port) == want


def test_layout_sorts_by_coordinate_then_id():
    entries = {"host-0/address": "10.0.0.2:1", "host-0/mesh": "1,0,0",
               "host-1/address": "10.0.0.1:1", "host-1/mesh": "0,0,0",
               "host-2/address": "10.0.0.3:1", "host-2/mesh": "*,0,0",
               "host-3/address": "10.0.0.4:1", "host-3/mesh": "1,0,0"}
    ranks = {h: tboot.derive_process_layout(entries, h, 9)[2]
             for h in ("host-0", "host-1", "host-2", "host-3")}
    assert ranks == {"host-1": 0, "host-0": 1, "host-3": 2, "host-2": 3}
    assert tboot.derive_process_layout(entries, "host-0", 9)[:2] == ("10.0.0.1:9", 4)


@pytest.fixture
def registries():
    """Two JAX registries in process (primary and standby), each with its
    own database, and a way to stop the primary."""
    out = []
    for _ in range(2):
        db = MemRegistryDB()
        service = RegistryService(db=db)
        service.watch.keepalive = 0.02
        out.append((db, registry_server("tcp://localhost:0", service)))
    yield out
    for _, server in out:
        server.force_stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_wait_for_hosts_redials_through_a_restart(registries, pkg):
    """The primary answers with one host, then goes down; the redial moves
    to the standby, where the second host is registered: both packages
    return the standby's rows."""
    (db0, primary), (db1, standby) = registries
    for db in (db0, db1):
        db.set("host-0/address", "127.0.0.1:7001")
        db.set("host-0/mesh", "1,0,0")
    mod, stub_cls = (jboot, JRegistryStub) if pkg == "jax" else (tboot, RegistryStub)
    channels = [dial(primary.addr, None)]
    redials = []

    def redial():
        redials.append(time.monotonic())
        channels.append(dial(standby.addr, None))
        return stub_cls(channels[-1])

    result = {}
    t = threading.Thread(target=lambda: result.update(entries=mod.wait_for_hosts(
        stub_cls(channels[0]), 2, timeout=20, poll=0.05, redial=redial)))
    t.start()
    time.sleep(0.3)
    primary.force_stop()
    time.sleep(0.2)
    db1.set("host-1/address", "127.0.0.1:7002")
    db1.set("host-1/mesh", "0,0,0")
    t.join(30)
    for ch in channels:
        ch.close()
    assert not t.is_alive() and redials
    assert result["entries"] == {"host-0/address": "127.0.0.1:7001", "host-0/mesh": "1,0,0",
                                 "host-1/address": "127.0.0.1:7002", "host-1/mesh": "0,0,0"}


def test_wait_for_hosts_timeouts_give_jax_messages(registries):
    (db0, primary), _ = registries
    db0.set("host-0/address", "127.0.0.1:7001")
    msgs = []
    for mod, stub_cls in ((jboot, JRegistryStub), (tboot, RegistryStub)):
        ch = dial(primary.addr, None)
        with pytest.raises(mod.BootstrapError) as e:
            mod.wait_for_hosts(stub_cls(ch), 3, timeout=0.2, poll=0.05)
        ch.close()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "only 1/3 hosts registered before timeout"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    msgs = []
    for mod, stub_cls in ((jboot, JRegistryStub), (tboot, RegistryStub)):
        ch = dial(dead, None)
        with pytest.raises(mod.BootstrapError) as e:
            mod.wait_for_hosts(stub_cls(ch), 1, timeout=0.3, poll=0.05)
        ch.close()
        msgs.append(str(e.value))
    assert msgs[0].startswith("registry unavailable through bootstrap timeout: ")
    assert [m.split(":")[0] for m in msgs] == [msgs[0].split(":")[0]] * 2


def test_initialize_from_one_host_joins_no_group(registries):
    (db0, primary), _ = registries
    db0.set("host-0/address", "127.0.0.1:7001")
    import torch.distributed as dist

    assert tboot.initialize_from_registry(primary.addr, "host-0", 1, timeout=5) == (0, 1)
    assert jboot.initialize_from_registry(primary.addr, "host-0", 1, timeout=5) == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(tboot.BootstrapError, match="not registered"):
        tboot.initialize_from_registry(primary.addr, "host-7", 1, timeout=5)


@pytest.mark.parametrize("who", ["host-0", "host-1"])
def test_initialize_joins_every_registered_host_as_jax(registries, monkeypatch, who):
    """``expected_hosts`` is the least the registry must hold: with one
    expected and two registered, both packages join the two-host group
    (the join itself recorded, not made)."""
    (db0, primary), _ = registries
    for h, coord in (("host-0", "1,0,0"), ("host-1", "0,0,0")):
        db0.set(f"{h}/address", f"127.0.0.{1 + int(h[-1])}:7001")
        db0.set(f"{h}/mesh", coord)
    joins = {"jax": [], "port": []}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: joins["jax"].append(kw))
    monkeypatch.setattr(tboot, "join_process_group",
                        lambda *a: joins["port"].append(a))
    want = jboot.initialize_from_registry(primary.addr, who, 1, timeout=5,
                                          coordinator_port=9)
    assert tboot.initialize_from_registry(primary.addr, who, 1, timeout=5,
                                          coordinator_port=9, device="cpu") == want
    assert want == ({"host-1": 0, "host-0": 1}[who], 2)
    (j,) = joins["jax"]
    assert joins["port"] == [(j["coordinator_address"], j["num_processes"],
                              j["process_id"], "cpu", 1)] == [("127.0.0.2:9", 2, want[0],
                                                               "cpu", 1)]


@pytest.mark.parametrize("who,local_rank,want", [
    ("host-1", 0, 0), ("host-1", 2, 2), ("host-0", 0, 3), ("host-0", 2, 5)])
def test_local_ranks_follow_their_host(registries, monkeypatch, who, local_rank, want):
    """Three processes a host (torchrun's LOCAL_WORLD_SIZE): host rank h's
    local rank l is rank 3h + l of 6, joined with the host's count."""
    (db0, primary), _ = registries
    for h, coord in (("host-0", "1,0,0"), ("host-1", "0,0,0")):
        db0.set(f"{h}/address", "127.0.0.1:7001")
        db0.set(f"{h}/mesh", coord)
    joins = []
    monkeypatch.setattr(tboot, "join_process_group", lambda *a: joins.append(a))
    assert tboot.initialize_from_registry(primary.addr, who, 2, timeout=5, device="cpu",
                                          local_rank=local_rank, local_ranks=3) == (want, 6)
    assert joins == [("127.0.0.1:8476", 6, want, "cpu", 3)]
    with pytest.raises(tboot.BootstrapError, match="local rank 3 is not one of 3"):
        tboot.initialize_from_registry(primary.addr, who, 2, timeout=5, local_rank=3,
                                       local_ranks=3)


LOCAL_RANK_CHILD = """
import json, os, sys
import torch, torch.distributed as dist
from oim_tpu_torch.cli import oim_trainer
args = oim_trainer.parse_args(sys.argv[1:])
device, made = oim_trainer.join(args)
t = torch.tensor([dist.get_rank()])
dist.all_reduce(t)
print(json.dumps([dist.get_rank(), dist.get_world_size(), int(t), device, made]))
dist.destroy_process_group()
"""


def test_trainer_join_under_torchrun_gives_each_local_rank_its_own(registries):
    """The trainer CLI's join in four real processes: two hosts, two
    torchrun ranks each (LOCAL_RANK, LOCAL_WORLD_SIZE=2). They form one
    gloo group of 4, host-1's ranks first."""
    (db0, primary), _ = registries
    for h, coord in (("host-0", "1,0,0"), ("host-1", "0,0,0")):
        db0.set(f"{h}/address", "127.0.0.1:7001")
        db0.set(f"{h}/mesh", coord)
    port = free_port()
    procs = []
    try:
        for host in ("host-0", "host-1"):
            for local in range(2):
                env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                           LOCAL_RANK=str(local), LOCAL_WORLD_SIZE="2")
                env.pop("WORLD_SIZE", None)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", LOCAL_RANK_CHILD, "--registry", primary.addr,
                     "--controller-id", host, "--expected-hosts", "2",
                     "--coordinator-port", str(port), "--device", "cpu",
                     "--log-level", "error"],
                    env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert got == [[2, 4, 6, "cpu", True], [3, 4, 6, "cpu", True],
                   [0, 4, 6, "cpu", True], [1, 4, 6, "cpu", True]]


# ----------------------------------------------- two ranks from the registry --


SEQ, BATCH, STEPS = 16, 4, 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_two_trainer_processes_assembled_from_the_registry(tmp_path):
    """Two port processes, controllers host-0 at 1,0,0 and host-1 at
    0,0,0, joined by the trainer CLI, on an int32 volume of STEPS batches:
    host-1 is rank 0. Staged over the mesh, each rank's plane reads half
    the volume's payload; then the trainer CLI trains on the same group.
    Both runs' losses, on both ranks, equal JAX's one-process Trainer on
    the same global batches within 2e-5."""
    vocab = 256
    tokens = np.random.default_rng(5).integers(0, vocab, (STEPS * BATCH, SEQ + 1),
                                               dtype=np.int32)
    path = tmp_path / "tokens.npy"
    np.save(path, tokens)
    common = dict(model="llama-tiny", batch_size=BATCH, seq_len=SEQ, lr=1e-2,
                  warmup_steps=2, total_steps=10, log_every=1, seed=3)
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**common), axes=[("data", 1)])
    jt.init_or_resume()
    np.savez(tmp_path / "init.npz", **flat(jax.tree.map(np.asarray, jt.state.params)))
    jlosses = []
    for i in range(STEPS):
        jt.state, stats = jt.step_fn(jt.state, jt.place_batch(
            {"tokens": tokens[i * BATCH:(i + 1) * BATCH]}))
        jlosses.append(float(stats["loss"]))

    db = MemRegistryDB()
    service = RegistryService(db=db)
    service.watch.keepalive = 0.02
    registry = registry_server("tcp://localhost:0", service)
    coord_port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = []
    try:
        for i, coord in enumerate(("1,0,0", "0,0,0")):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "torch_bootstrap_child.py"),
                 "--registry", registry.addr, "--controller-id", f"host-{i}",
                 "--mesh-coord", coord, "--coordinator-port", str(coord_port),
                 "--volume-file", str(path), "--init", str(tmp_path / "init.npz"),
                 "--out", str(tmp_path / f"host-{i}.json"),
                 "--model", "llama-tiny", "--rules", "dp", "--mesh", "data=2",
                 "--steps", str(STEPS), "--batch-size", str(BATCH), "--seq-len", str(SEQ),
                 "--lr", "1e-2", "--warmup-steps", "2", "--log-every", "1", "--seed", "3",
                 "--feed-window-bytes", "0", "--prefetch-batches", "0",
                 "--log-level", "error"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"host-{i}:\n{outs[i][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        registry.force_stop()
    ranks = {h: json.loads((tmp_path / f"{h}.json").read_text()) for h in ("host-0", "host-1")}
    assert ranks["host-1"]["rank"] == 0 and ranks["host-0"]["rank"] == 1
    assert {r["world"] for r in ranks.values()} == {2}
    assert {r["init_method"] for r in ranks.values()} == {f"tcp://127.0.0.1:{coord_port}"}
    for r in ranks.values():
        placed = r["placed"]
        assert placed["is_placed"] and placed["local_rows"] == [STEPS, BATCH // 2, SEQ + 1]
        assert placed["bytes_read"] == tokens.nbytes // 2
        for run in ("placed", "cli"):
            losses = [h["loss"] for h in r[run]["history"] if "loss" in h]
            np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-5, err_msg=run)


def test_bootstrap_loads_without_grpc():
    """The card's path imports the bootstrap's layout and join: loading the
    module (and the trainer CLI) loads neither grpc nor protobuf."""
    code = ("import sys\nimport oim_tpu_torch.parallel.bootstrap\n"
            "import oim_tpu_torch.cli.oim_trainer\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'grpc' "
            "or m.startswith('google.protobuf')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
