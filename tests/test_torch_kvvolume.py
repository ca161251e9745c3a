"""The port's fleet KV tier's volumes (``oim_tpu_torch/serve/kvvolume.py``)
and its batched page write (``kvtier.stage_pages``) held against the JAX
package's on the CPU, at llama.tiny (vocab 64, dim 32, 2 layers, f32) with
JAX's weights carried across.

* ``pack_chain`` gives the JAX package's bytes for the same f32 and bf16
  blocks (bf16 as the port's ``uint16`` bits or as ``ml_dtypes``), each
  package unpacks the other's blob to the same bits, and
  ``config_fingerprint`` and ``chain_volume_id`` are equal for the two
  ``Config``s.
* Every defect JAX's ``TestVolumeDeterminism`` covers is refused by both
  with the same message.
* ``snapshot_chain`` of a port engine equals JAX's for the same prompt
  within 2e-5, and two port engines export the same bytes.
* ``stage_pages`` writes what N ``stage_page`` calls write, to the bit, at
  shard 1 and shard 2, and refuses a block the pool cannot take.
* ``ChainFetcher`` probes, counts and refuses as JAX's
  ``PeerPrefixFetcher``; the serve row carries ``prefix_volumes`` and the
  role, which JAX's ``Replica.parse`` reads.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from oim_tpu.models import llama as jllama
from oim_tpu.router.table import Replica
from oim_tpu.serve import ServeEngine as JServeEngine
from oim_tpu.serve import kvvolume as jkv
from oim_tpu.serve import load_snapshot as jload_snapshot
from oim_tpu_torch.common import metrics as tmetrics
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.serve import ServeEngine as TServeEngine
from oim_tpu_torch.serve import kvtier as tkvtier
from oim_tpu_torch.serve import kvvolume as tkv
from oim_tpu_torch.serve import shard as tshard
from oim_tpu_torch.serve.registration import load_snapshot as tload_snapshot

torch.set_num_threads(2)

FP = {"n_layers": 2, "n_kv_heads": 1, "head_dim": 8, "dtype": "float32", "page_tokens": 4}


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, JAX cfg, port cfg): one set of weights."""
    jcfg = jllama.tiny(vocab=64, dim=32, n_layers=2)
    tcfg = tllama.tiny(vocab=64, dim=32, n_layers=2)
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    return jp, tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), jcfg, tcfg


def _chain(dtype=np.float32, rs=4, n=3):
    """JAX's TestVolumeDeterminism chain: n blocks [L=2, 4, 1, 8]."""
    rng = np.random.RandomState(rs)
    hashes = [f"h{i:02d}" for i in range(n)]
    blocks = [(rng.rand(2, 4, 1, 8).astype(dtype), rng.rand(2, 4, 1, 8).astype(dtype))
              for _ in hashes]
    return hashes, blocks, dict(FP, dtype=np.dtype(dtype).name)


def _bits(blocks):
    return [(k.view(np.uint16), v.view(np.uint16)) for k, v in blocks]


# ----------------------------------------------------------- the blob ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_chain_bytes_equal_jax(dtype):
    hashes, blocks, fp = _chain(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    if dtype == "float32":
        assert tkv.pack_chain(hashes, blocks, 4, fp) == jkv.pack_chain(hashes, blocks, 4, fp)
        return
    # JAX packs bf16 blocks given as numpy's raw 2-byte view ("void16",
    # which it names bfloat16); a buffer of ml_dtypes' bf16 has no format
    # its memoryview accepts.
    raw = [(k.view("V2"), v.view("V2")) for k, v in blocks]
    want = jkv.pack_chain(hashes, raw, 4, fp)
    assert json.loads(want[16:16 + int.from_bytes(want[8:16], "little")])["dtype"] == \
        "bfloat16"
    # The port's own bf16 blocks are uint16 bits, named by the pool's dtype.
    assert tkv.pack_chain(hashes, _bits(blocks), 4, fp, dtype="bfloat16") == want
    assert tkv.pack_chain(hashes, blocks, 4, fp) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_unpacks_the_others_blob(dtype):
    hashes, blocks, fp = _chain(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    raw = [(k.view("V2"), v.view("V2")) for k, v in blocks] if dtype == "bfloat16" else blocks
    jblob = jkv.pack_chain(hashes, raw, 4, fp)
    got_hashes, got, block = tkv.unpack_chain(jblob, fp)
    assert (got_hashes, block) == (hashes, 4)
    for (k, v), (gk, gv) in zip(blocks, got):
        assert gk.tobytes() == k.tobytes() and gv.tobytes() == v.tobytes()
    if dtype == "bfloat16":
        assert got[0][0].dtype == np.uint16  # the port's bits of a bf16 block
    tblob = tkv.pack_chain(hashes, got, 4, fp, dtype=fp["dtype"])
    back_hashes, back, _ = jkv.unpack_chain(tblob, fp)
    assert back_hashes == hashes
    assert [(k.tobytes(), v.tobytes()) for k, v in back] == \
        [(k.tobytes(), v.tobytes()) for k, v in blocks]
    # A uint8 tensor's numpy view (a staged volume read back) unpacks too.
    assert tkv.unpack_chain(np.frombuffer(jblob, np.uint8).copy(), fp)[0] == hashes


@pytest.mark.parametrize("which", ["llama-tiny", "llama3-8b"])
def test_fingerprint_and_volume_id_equal_jax(which):
    jcfg = jllama.tiny() if which == "llama-tiny" else jllama.LLAMA3_8B
    tcfg = tllama.tiny() if which == "llama-tiny" else tllama.LLAMA3_8B
    for page in (4, 16):
        assert tkv.config_fingerprint(tcfg, page) == jkv.config_fingerprint(jcfg, page)
    assert tkv.config_fingerprint(tllama.LLAMA3_8B, 16)["dtype"] == "bfloat16"
    hashes = ["a1", "b2", "c3"]
    assert tkv.chain_volume_id(hashes) == jkv.chain_volume_id(hashes) == "kvchain-c3"
    assert tkv.VOLUME_PREFIX == jkv.VOLUME_PREFIX


def _raise_msg(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


DEFECTS = {
    "bad magic": lambda blob, fp: (b"JUNK" + blob[4:], fp),
    "truncated": lambda blob, fp: (blob[:-8], fp),
    "fingerprint": lambda blob, fp: (blob, dict(fp, head_dim=16)),
    "other page_tokens": lambda blob, fp: (blob, dict(fp, page_tokens=8)),
}


@pytest.mark.parametrize("defect", DEFECTS)
def test_unpack_refuses_every_defect_as_jax_does(defect):
    hashes, blocks, fp = _chain()
    blob, pin = DEFECTS[defect](jkv.pack_chain(hashes, blocks, 4, fp), fp)
    assert _raise_msg(tkv.unpack_chain, blob, pin) == _raise_msg(jkv.unpack_chain, blob, pin)


def test_unpack_without_a_pin_trusts_the_manifest():
    hashes, blocks, fp = _chain()
    assert tkv.unpack_chain(tkv.pack_chain(hashes, blocks, 4, fp), None)[0] == hashes


@pytest.mark.parametrize("case", ["count", "empty", "ragged", "empty id"])
def test_pack_refuses_what_jax_refuses(case):
    hashes, blocks, fp = _chain()
    if case == "empty id":
        assert _raise_msg(tkv.chain_volume_id, []) == _raise_msg(jkv.chain_volume_id, [])
        return
    args = {"count": (hashes, blocks[:-1], 4, fp), "empty": ([], [], 4, fp),
            "ragged": (hashes, blocks[:-1] + [(blocks[-1][0][:, :2], blocks[-1][1])], 4,
                       fp)}[case]
    assert _raise_msg(tkv.pack_chain, *args) == _raise_msg(jkv.pack_chain, *args)


def test_chain_request_equals_jax(tmp_path):
    path = str(tmp_path / "c.bin")
    want = jkv.chain_request("kvchain-x", path, 1234)
    got = tkv.chain_request("kvchain-x", path, 1234)
    assert got.SerializeToString() == want.SerializeToString()


# ------------------------------------------------- engines and pages ----


def engines(model, **kw):
    jp, tp, jcfg, tcfg = model
    kw = {"max_batch": 2, "max_seq": 64, "queue_depth": 8, "prefix_block": 4, **kw}
    return JServeEngine(jp, jcfg, **kw), TServeEngine(tp, tcfg, device="cpu", **kw)


PROMPT = np.random.RandomState(5).randint(1, 64, 14).tolist()  # 3 full blocks + 2


def test_snapshot_chain_matches_jax(model):
    pair = engines(model)
    try:
        for eng in pair:
            eng.submit(PROMPT, max_new=2).result(timeout=120)
        (jchain,), (tchain,) = (eng.hot_chains(1) for eng in pair)
        assert tchain == jchain and len(tchain) == 3
        jblocks, tblocks = (eng.snapshot_chain(jchain) for eng in pair)
        assert pair[1].snapshot_chain(["no-such-hash"]) is None
        assert pair[1].snapshot_chain([]) is None
    finally:
        for eng in pair:
            eng.stop(timeout=30)
    assert len(tblocks) == len(jblocks) == 3
    for (jk, jv), (tk, tv) in zip(jblocks, tblocks):
        assert tk.shape == jk.shape == (2, 4, 2, 8) and tk.dtype == np.float32
        np.testing.assert_allclose(tk, jk, atol=2e-5, rtol=0)
        np.testing.assert_allclose(tv, jv, atol=2e-5, rtol=0)


def test_two_port_engines_export_identical_bytes_and_id(model):
    _, tp, _, tcfg = model
    pair = [TServeEngine(tp, tcfg, device="cpu", max_batch=2, max_seq=64, prefix_block=4)
            for _ in range(2)]
    try:
        blobs = []
        for eng in pair:
            eng.submit(PROMPT, max_new=2).result(timeout=120)
            (chain,) = eng.hot_chains(1)
            fp = tkv.config_fingerprint(eng.cfg, eng.page_tokens)
            blobs.append((tkv.pack_chain(chain, eng.snapshot_chain(chain), 4, fp),
                          tkv.chain_volume_id(chain)))
    finally:
        for eng in pair:
            eng.stop(timeout=30)
    assert blobs[0] == blobs[1]


def _pools(dtype, shard):
    """A pool [L=2, 9 pages, 4, kvh=2, 8] (or each member's KV-head slice)
    and 3 random blocks of whole pages, as the host tier holds them."""
    rng = np.random.RandomState(11)
    shape = (2, 9, 4, 2, 8)
    full = {n: torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dtype)
            for n in ("k", "v")}
    blocks = [tuple(torch.from_numpy(rng.rand(2, 4, 2, 8).astype(np.float32)).to(dtype)
                    for _ in range(2)) for _ in range(3)]
    host = [tuple(tkvtier._to_host(t) for t in kv) for kv in blocks]
    if shard == 1:
        return [{n: t.clone() for n, t in full.items()} for _ in range(2)], host
    spec = tshard.pool_specs()["k"]
    members = [{n: tshard.member_slice(t, spec, shard, r).clone() for n, t in full.items()}
               for r in range(shard)]
    return [[{n: t.clone() for n, t in m.items()} for m in members] for _ in range(2)], host


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shard", [1, 2])
def test_stage_pages_equals_page_by_page(dtype, shard):
    (batched, single), host = _pools(dtype, shard)
    pages = [7, 2, 5]
    ks, vs = [k for k, _ in host], [v for _, v in host]
    if shard == 1:
        tkvtier.stage_pages(batched, pages, ks, vs)
        for p, k, v in zip(pages, ks, vs):
            tkvtier.stage_page(single, p, k, v)
        pairs = [(batched, single)]
    else:
        tshard.stage_pool_pages(batched, pages, ks, vs, tkvtier.stage_pages)
        for p, k, v in zip(pages, ks, vs):
            tshard.stage_pool_page(single, p, k, v, tkvtier.stage_page)
        pairs = list(zip(batched, single))
    for a, b in pairs:
        for n in ("k", "v"):
            assert torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
    # What landed reads back as the blocks, whole pages at any shard.
    read = (lambda p: tkvtier.page_kv(batched, p)) if shard == 1 else \
        (lambda p: tshard.pool_page_kv(batched, p, tkvtier.page_kv))
    for p, (k, v) in zip(pages, host):
        gk, gv = read(p)
        assert gk.tobytes() == k.tobytes() and gv.tobytes() == v.tobytes()


@pytest.mark.parametrize("bad", ["shape", "itemsize"])
def test_stage_pages_refuses_a_block_the_pool_cannot_take(bad):
    (pool, _), host = _pools(torch.bfloat16, 1)
    before = {n: t.clone() for n, t in pool.items()}
    ks, vs = [k for k, _ in host], [v for _, v in host]
    ks[1] = ks[1][:, :2] if bad == "shape" else ks[1].astype(np.float32)
    with pytest.raises(ValueError):
        tkvtier.stage_pages(pool, [1, 2, 3], ks, vs)
    assert all(torch.equal(pool[n], before[n]) for n in pool)


# --------------------------------------------------------- the fetcher ----


def _counts():
    fam = tmetrics.SERVE_PREFIX_PEER_FETCHES
    return {o: fam.labels(outcome=o).value for o in ("hit", "miss", "error")}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def test_fetcher_probes_hits_and_misses_as_jax_does():
    hashes, blocks, fp = _chain(n=4)
    store = {tkv.chain_volume_id(hashes[:3]): np.frombuffer(
        tkv.pack_chain(hashes[:3], blocks[:3], 4, fp), np.uint8)}
    probed = []

    def read(vid):
        probed.append(vid)
        return store.get(vid)

    before = _counts()
    got = tkv.ChainFetcher(read, fp)(hashes, 1)  # local: every depth, deepest first
    assert [k for k, _ in got] == hashes[1:3]
    assert probed == [tkv.chain_volume_id(hashes[:j]) for j in (4, 3)]
    assert [b.tobytes() for _, kv in got for b in kv] == \
        [b.tobytes() for kv in blocks[1:3] for b in kv]
    assert _delta(before) == {"hit": 1}
    probed.clear()
    assert tkv.ChainFetcher(read, fp, scan=False)(hashes, 1) == []  # remote: full chain only
    assert probed == [tkv.chain_volume_id(hashes)]
    probed.clear()
    assert tkv.ChainFetcher(read, fp, known=lambda: {hashes[1]})(hashes, 0) == []
    assert probed == [tkv.chain_volume_id(hashes[:2])]
    assert _delta(before) == {"hit": 1, "miss": 2}
    # A volume holding another chain than its address names is an error.
    store[tkv.chain_volume_id(hashes)] = store[tkv.chain_volume_id(hashes[:3])]
    assert tkv.ChainFetcher(read, fp)(hashes, 0) is None
    assert tkv.ChainFetcher(read, dict(fp, page_tokens=8))(hashes[:3], 0) is None
    assert _delta(before) == {"hit": 1, "miss": 2, "error": 2}


def test_serve_row_carries_volumes_and_role_that_jax_parses(model):
    pair = engines(model, role="prefill")
    try:
        rows = []
        for eng, snapshot in zip(pair, (jload_snapshot, tload_snapshot)):
            cold = snapshot("h:1", eng)
            assert cold["role"] == "prefill" and cold["prefix_block"] == 4
            eng.submit(PROMPT, max_new=2).result(timeout=120)
            eng.note_exported("deadbeef", "kvchain-deadbeef")
            rows.append(snapshot("h:1", eng))
    finally:
        for eng in pair:
            eng.stop(timeout=30)
    jrow, trow = rows
    assert trow.keys() == jrow.keys()
    assert trow["prefix_volumes"] == jrow["prefix_volumes"] == {"deadbeef": "kvchain-deadbeef"}
    assert trow["prefix_hashes"] == jrow["prefix_hashes"]
    rep = Replica.parse("serve/t0", json.dumps(trow))
    assert (rep.role, rep.prefix_volumes, rep.prefix_block) == (
        "prefill", frozenset({"deadbeef"}), 4)


def test_engine_refuses_an_unknown_role_as_jax_does(model):
    jp, tp, jcfg, tcfg = model
    msgs = []
    for build in (lambda: JServeEngine(jp, jcfg, role="chef"),
                  lambda: TServeEngine(tp, tcfg, device="cpu", role="chef")):
        with pytest.raises(ValueError) as err:
            build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_kvvolume_and_the_cli_load_no_grpc_or_protobuf():
    """The card machine has neither: the fleet tier's cores and the CLI
    module import without them."""
    code = ("import sys; import oim_tpu_torch.serve.kvvolume, oim_tpu_torch.cli.oim_serve; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('grpc', 'jax', "
            "'oim_tpu') or m.startswith('google.protobuf')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
