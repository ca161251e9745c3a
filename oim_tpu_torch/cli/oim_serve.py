"""oim-serve for the port (``oim_tpu/cli/oim_serve.py``): the
continuous-batching inference daemon over the port's ``ServeEngine``,
answering ``oim.v1.Serve/Generate`` with JAX's wire format, so JAX's
router and ``oimctl`` treat a port replica as one of their own.

Weights come from exactly one of three sources:

* ``--checkpoint-dir`` (+ ``--model``): restore a checkpoint of the port's
  trainer in process. ``--pack-to FILE`` also writes the packed weights
  blob, the artifact every replica publishes from.
* ``--weights-file``: a packed blob (``serve/weights.py``), published as a
  volume through the feeder, local (``--backend cuda|malloc``) or remote
  (``--registry`` + ``--controller-id``), and restored from the staged
  bytes. ``--prestage PEER_ID`` (repeatable) warms other controllers'
  stage caches, so their replicas boot from a cache hit.
* ``--restore-only`` (remote mode): the ``--weights-volume`` is already
  mapped on this replica's controller; restore from it.

The draft model of ``--spec-tokens`` comes the same three ways
(``--draft-checkpoint-dir``, ``--draft-weights-file``,
``--draft-restore-only``). ``--serve-id`` registers the replica's
``serve/<id>`` row (``--advertise``, ``--heartbeat``, ``--weights-version``);
with ``--shard N`` each member's lease row is registered before the serve
row's first beat. SIGTERM or Ctrl-C drains: the row announces
``ready: false``, residents finish, queued requests close as "drained",
then the rows are deleted and the server stops. ``--device`` (default
``cuda``) is the JAX CLI's ``--platform``; ``--device cpu`` serves on the
CPU:

    python -m oim_tpu_torch.cli.oim_serve --checkpoint-dir ckpt \\
        --model llama-tiny --endpoint tcp://127.0.0.1:9002 --device cpu

The fleet KV tier (``serve/kvvolume.py``) needs a feeder (``--backend`` or
remote mode): ``--kv-peer-fetch`` adopts peer-exported chain volumes on a
prefix miss, ``--kv-export`` publishes the hot chains every ``--heartbeat``
seconds, and ``--role prefill`` exports each retired request's chain before
its stream closes (``--role decode`` pairs with ``--kv-peer-fetch``). This
module imports grpcio only when it serves, so it loads on a machine without
it.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from oim_tpu_torch.cli.common import (
    add_common_flags,
    add_observability_flags,
    add_registry_flag,
    load_tls_flags,
    setup_logging,
    start_observability,
    start_telemetry_row,
)
from oim_tpu_torch.common.logging import from_context

DEFAULT_VOLUME = "weights"
MODELS = ("llama-tiny", "llama-tiny-moe", "llama3-8b")


def _checkpoint_params(model: str, checkpoint_dir: str, device: str, what: str, log):
    """(params, model config) of the latest checkpoint in ``checkpoint_dir``;
    SystemExit when there is none (refused before a random init is drawn)."""
    from oim_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(model=model, checkpoint_dir=checkpoint_dir)
    trainer = Trainer(cfg, device=device)
    if trainer.checkpointer is None or trainer.checkpointer.latest_step() is None:
        if what == "draft":
            raise SystemExit(f"no draft checkpoint found in {checkpoint_dir!r} "
                             "(refusing to speculate from random init)")
        raise SystemExit(f"no checkpoint found in {checkpoint_dir!r} "
                         "(refusing to serve random init)")
    step = trainer.init_or_resume()
    log.info(f"restored {what} checkpoint" if what == "draft" else "restored checkpoint",
             step=step, model=model)
    return trainer.state.params, cfg.model_config()


def _volume_params(args, feeder, volume: str, path: str, log):
    """Publish ``path`` as ``volume`` (when given), prestage it to every
    ``--prestage`` peer, and restore the tree from the staged bytes."""
    from oim_tpu_torch.serve.weights import publish_weights, restore_weights, weights_request

    if path:
        request = weights_request(volume, path, os.path.getsize(path))
        publish_weights(feeder, volume, path)
        for peer in args.prestage:
            _prestage_peer(feeder, request, peer, log)
    return restore_weights(feeder, volume)


def _load_params(args, log):
    """(params, model config, feeder) from whichever source was given; the
    feeder (None in checkpoint-dir mode) is shared with the draft loader."""
    from oim_tpu_torch.train import TrainConfig

    if args.checkpoint_dir:
        params, mcfg = _checkpoint_params(args.model, args.checkpoint_dir, args.device,
                                          "target", log)
        if args.pack_to:
            from oim_tpu_torch.serve.weights import save_packed

            size = save_packed(params, args.pack_to)
            log.info("packed weights", path=args.pack_to, bytes=size)
        return params, mcfg, None
    # The blob carries only the param tree; the config shapes the KV cache.
    mcfg = TrainConfig(model=args.model).model_config()
    feeder = _make_feeder(args)
    params = _volume_params(args, feeder, args.weights_volume, args.weights_file, log)
    log.info("restored weights volume", volume=args.weights_volume)
    return params, mcfg, feeder


def _load_draft_params(args, log, feeder=None):
    """The speculative-decoding draft model from its source: a packed blob
    is a second content-addressed volume with the same prestage fan-out."""
    from oim_tpu_torch.train import TrainConfig

    if args.draft_checkpoint_dir:
        return _checkpoint_params(args.draft_model, args.draft_checkpoint_dir,
                                  args.device, "draft", log)
    mcfg = TrainConfig(model=args.draft_model).model_config()
    if feeder is None:  # the target came from a checkpoint dir
        feeder = _make_feeder(args)
    params = _volume_params(args, feeder, args.draft_weights_volume,
                            args.draft_weights_file, log)
    log.info("restored draft weights volume", volume=args.draft_weights_volume)
    return params, mcfg


def _make_feeder(args):
    from oim_tpu_torch.feeder import Feeder

    if args.backend:
        from oim_tpu_torch.controller import CUDABackend, MallocBackend
        from oim_tpu_torch.controller.controller import ControllerService

        backend = CUDABackend(device=args.device) if args.backend == "cuda" else MallocBackend()
        return Feeder(controller=ControllerService(backend),
                      window_compress=args.window_compress)
    if not (args.registry and args.controller_id):
        raise SystemExit(
            "--weights-file/--weights-volume need --backend (local) or "
            "--registry + --controller-id (remote)"
        )
    return Feeder(registry_address=args.registry, controller_id=args.controller_id,
                  tls=load_tls_flags(args), window_compress=args.window_compress)


def _prestage_peer(feeder, request, peer: str, log) -> None:
    """Warm ``peer``'s stage cache with the weights through the registry
    proxy, so that replica's later publish is an O(1) hit."""
    import grpc

    from oim_tpu_torch.common.pathutil import CONTROLLER_ID_META
    from oim_tpu_torch.spec.services import ControllerStub

    try:
        ControllerStub(feeder._registry_channel()).PrestageVolume(
            request, metadata=[(CONTROLLER_ID_META, peer)], timeout=60.0)
        log.info("prestaged replica", peer=peer, volume=request.volume_id)
    except grpc.RpcError as err:
        log.warning("replica prestage failed", peer=peer, error=err.code().name)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("oim-serve (torch)")
    parser.add_argument("--endpoint", default="tcp://0.0.0.0:9002",
                        help="listen endpoint (tcp:// or unix://)")
    parser.add_argument("--model", default="llama-tiny", choices=MODELS)
    parser.add_argument("--checkpoint-dir", default="",
                        help="restore a checkpoint of the port's trainer in process")
    parser.add_argument("--pack-to", default="",
                        help="with --checkpoint-dir: also write the packed weights blob "
                             "(the file replicas publish with --weights-file)")
    parser.add_argument("--weights-file", default="",
                        help="packed weights blob to publish-and-restore through the "
                             "control plane (idempotent; a prestaged replica's publish "
                             "is an O(1) stage-cache hit)")
    parser.add_argument("--weights-volume", default=DEFAULT_VOLUME,
                        help="volume id for the weights (with --weights-file: publish "
                             "under this id; with --restore-only: restore the "
                             "already-mapped volume)")
    parser.add_argument("--weights-version", default="",
                        help="weights version advertised in the serve/<id> row (rolling "
                             "upgrades); empty = unversioned")
    parser.add_argument("--restore-only", action="store_true",
                        help="remote mode without --weights-file: restore "
                             "--weights-volume as already mapped on the controller")
    parser.add_argument("--backend", default="", choices=("", "malloc", "cuda"),
                        help="local mode: in-process controller backend (cuda stages "
                             "onto --device)")
    add_registry_flag(parser, help_suffix="remote mode")
    parser.add_argument("--controller-id", default="",
                        help="remote mode: this replica's controller")
    parser.add_argument("--prestage", action="append", default=[],
                        help="controller id to PrestageVolume the weights to after "
                             "publishing (repeatable)")
    parser.add_argument("--serve-id", default="",
                        help="register this replica in the routing table: a TTL-leased "
                             "serve/<id> row with endpoint + load snapshot, re-published "
                             "every --heartbeat seconds (needs --registry)")
    parser.add_argument("--advertise", default="",
                        help="endpoint routers dial for this replica (default: the bound "
                             "listen address; required when the endpoint binds a "
                             "wildcard address)")
    parser.add_argument("--heartbeat", type=float, default=10.0,
                        help="seconds between serve/<id> row re-publishes; the lease is "
                             "2.5x this")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="decode-batch slots (continuous batch width)")
    parser.add_argument("--max-seq", type=int, default=256,
                        help="KV length: prompt + generated tokens per request must fit")
    parser.add_argument("--queue-depth", type=int, default=64,
                        help="bounded admission queue; full = RESOURCE_EXHAUSTED")
    parser.add_argument("--prefix-cache-bytes", type=int, default=64 << 20,
                        help="byte budget of the prompt-prefix KV cache (0 disables)")
    parser.add_argument("--prefix-block", type=int, default=16,
                        help="tokens per prefix-cache block (advertised in the row)")
    parser.add_argument("--kv-page-tokens", type=int, default=0,
                        help="tokens per KV page (0 = --prefix-block)")
    parser.add_argument("--kv-pool-tokens", type=int, default=0,
                        help="KV tokens in the page pool all slots share "
                             "(0 = max-batch x max-seq)")
    parser.add_argument("--kv-host-bytes", type=int, default=0,
                        help="host-RAM budget for demoted KV prefix pages (0 disables)")
    parser.add_argument("--kv-peer-fetch", action="store_true",
                        help="resolve prefix misses against peer-exported KV volumes "
                             "(content-addressed kvchain-* volumes on the control plane) "
                             "before recomputing; any failure recomputes locally. Needs a "
                             "feeder (--backend or remote mode)")
    parser.add_argument("--kv-export", action="store_true",
                        help="publish this replica's hot prefix chains as content-addressed "
                             "KV volumes every --heartbeat seconds. Needs a feeder")
    parser.add_argument("--role", default="mixed", choices=("prefill", "decode", "mixed"),
                        help="disaggregation role, advertised in the serve row: prefill "
                             "exports each retired request's chain as a kvchain volume "
                             "(needs a control plane), decode streams (pair with "
                             "--kv-peer-fetch), mixed does both")
    parser.add_argument("--prefill-chunk", type=int, default=0,
                        help="prefill long prompts in slices of this many tokens "
                             "(0 = one full-length prefill)")
    parser.add_argument("--window-compress", action="store_true",
                        help="ask volume servers to zlib-compress ReadVolume window chunks")
    parser.add_argument("--spec-tokens", type=int, default=0,
                        help="speculative decoding: tokens the draft proposes per verify "
                             "round (0 disables); needs exactly one draft source")
    parser.add_argument("--draft-model", default="llama-tiny", choices=MODELS,
                        help="draft model config (must share the target's vocabulary)")
    parser.add_argument("--draft-checkpoint-dir", default="",
                        help="restore the draft model from a checkpoint in process")
    parser.add_argument("--draft-weights-file", default="",
                        help="packed draft blob to publish-and-restore as a second volume")
    parser.add_argument("--draft-weights-volume", default="draft-weights",
                        help="volume id for the draft weights blob")
    parser.add_argument("--draft-restore-only", action="store_true",
                        help="remote mode without --draft-weights-file: restore "
                             "--draft-weights-volume as already mapped")
    parser.add_argument("--spec-pool-tokens", type=int, default=0,
                        help="KV tokens in the draft's page pool (0 = the target's)")
    parser.add_argument("--shard", type=int, default=1,
                        help="tensor-parallel width: one replica over this many members, "
                             "on the first --shard cards (all on the CPU with --device "
                             "cpu); with --serve-id each member holds a "
                             "serve/<id>.member.<k> lease")
    parser.add_argument("--member-hbm-budget", type=int, default=0,
                        help="per-member byte budget: refuse to boot when one member's "
                             "weights + pool slice exceed it (0 disables)")
    parser.add_argument("--stream-tokens", type=int, default=1,
                        help="token-stream granularity: the first token flushes at once, "
                             "later deltas batch up to this many tokens")
    parser.add_argument("--default-max-new", type=int, default=64,
                        help="decode budget when a request leaves max_new_tokens unset")
    parser.add_argument("--drain-timeout", type=float, default=60.0,
                        help="graceful-drain budget on shutdown")
    parser.add_argument("--device", default="cuda",
                        help="torch device the engine serves on (default cuda; cpu runs "
                             "the plain versions)")
    add_common_flags(parser)
    add_observability_flags(parser)
    return parser.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """SystemExit for flags that cannot run, before anything starts: the
    JAX CLI's refusals with its messages."""
    sources = bool(args.checkpoint_dir) + bool(args.weights_file) + bool(args.restore_only)
    if sources != 1:
        raise SystemExit(
            "exactly one weights source required: --checkpoint-dir, "
            "--weights-file, or --restore-only (+ --weights-volume)"
        )
    draft_sources = (bool(args.draft_checkpoint_dir) + bool(args.draft_weights_file)
                     + bool(args.draft_restore_only))
    if args.spec_tokens > 0 and draft_sources != 1:
        raise SystemExit(
            "--spec-tokens needs exactly one draft source: "
            "--draft-checkpoint-dir, --draft-weights-file, or "
            "--draft-restore-only (+ --draft-weights-volume)")
    if draft_sources and args.spec_tokens < 1:
        raise SystemExit(
            "a draft source without --spec-tokens >= 1 does nothing; "
            "set the proposal depth or drop the draft flags")
    if args.draft_restore_only and args.backend:
        raise SystemExit(
            "--draft-restore-only restores an already-mapped volume "
            "and needs remote mode (--registry + --controller-id)")
    if args.prestage and args.backend:
        # _prestage_peer routes through the registry proxy, which a local
        # in-process backend does not have.
        raise SystemExit("--prestage needs remote mode (--registry + "
                         "--controller-id), not --backend")
    if args.serve_id and not args.registry:
        raise SystemExit("--serve-id registers in the routing table and "
                         "needs --registry")
    if (args.kv_peer_fetch or args.kv_export) and args.checkpoint_dir:
        raise SystemExit(
            "--kv-peer-fetch/--kv-export need a control plane "
            "(--backend or --registry + --controller-id), not "
            "--checkpoint-dir")
    if args.role == "prefill" and args.checkpoint_dir:
        raise SystemExit(
            "--role prefill exports KV chains and needs a control "
            "plane (--backend or --registry + --controller-id), not "
            "--checkpoint-dir")


def _start_exporter(engine, feeder, interval: float, stop: threading.Event) -> None:
    """Every ``interval`` seconds until ``stop``, export each of the engine's
    hot chains not exported yet (``export_chain``); a chain that partly
    evicted since its admission exports nothing, a failure is logged."""
    from oim_tpu_torch.serve.kvvolume import export_chain

    def loop():
        elog = from_context()
        while not stop.wait(interval):
            done = set(engine.exported_volumes())
            for chain in engine.hot_chains():
                if not chain or chain[-1] in done:
                    continue
                try:
                    export_chain(engine, feeder, list(chain))
                except Exception as err:  # noqa: BLE001 - keep beating
                    elog.warning("kv chain export failed", error=repr(err))

    threading.Thread(target=loop, name="oim-kv-export", daemon=True).start()


def _advertise(args, addr: str) -> str:
    """The endpoint the serve row advertises; SystemExit for a wildcard,
    which would make every router dial its own loopback."""
    advertise = args.advertise or addr
    host = advertise.rsplit(":", 1)[0]
    if host in ("0.0.0.0", "[::]", "::"):
        raise SystemExit(
            f"--serve-id would advertise the wildcard address "
            f"{advertise!r}; pass --advertise host:port with the "
            f"address routers should dial")
    return advertise


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    setup_logging(args)
    log = from_context()
    check_args(args)
    obs = start_observability(args, "oim-serve")

    from oim_tpu_torch.serve import ServeEngine
    from oim_tpu_torch.serve.service import ServeService, serve_server

    params, mcfg, feeder = _load_params(args, log)
    draft_params, draft_mcfg = (None, None)
    if args.spec_tokens > 0:
        draft_params, draft_mcfg = _load_draft_params(args, log, feeder=feeder)
    kv_fetch = None
    if args.kv_peer_fetch:
        from oim_tpu_torch.serve.kvvolume import PeerPrefixFetcher, config_fingerprint

        page_tokens = args.kv_page_tokens or args.prefix_block
        kv_fetch = PeerPrefixFetcher(feeder, config_fingerprint(mcfg, page_tokens))
    engine = ServeEngine(
        params, mcfg,
        max_batch=args.max_batch,
        max_seq=args.max_seq,
        queue_depth=args.queue_depth,
        default_max_new=args.default_max_new,
        prefix_cache_bytes=args.prefix_cache_bytes,
        prefix_block=args.prefix_block,
        kv_page_tokens=args.kv_page_tokens,
        kv_pool_tokens=args.kv_pool_tokens,
        kv_host_bytes=args.kv_host_bytes,
        kv_fetch=kv_fetch,
        draft_params=draft_params,
        draft_cfg=draft_mcfg,
        spec_tokens=args.spec_tokens,
        spec_pool_tokens=args.spec_pool_tokens,
        shard=args.shard,
        member_hbm_budget=args.member_hbm_budget,
        role=args.role,
        prefill_chunk=args.prefill_chunk,
        device=args.device,
        devices=[args.device] * args.shard if args.device == "cpu" else None,
    )
    if args.role == "prefill" and feeder is not None:
        # The prefill tier exports at RETIREMENT: the decode pick is already
        # waiting on the volume, so the --kv-export sweep is too late.
        from oim_tpu_torch.serve.kvvolume import export_chain

        engine.set_handoff_export(lambda eng, hashes: export_chain(eng, feeder, hashes))
    tls = load_tls_flags(args)
    server = serve_server(args.endpoint, ServeService(engine, stream_tokens=args.stream_tokens),
                          tls=tls)
    log.info("oim-serve serving", endpoint=args.endpoint, addr=server.addr,
             model=args.model, max_batch=args.max_batch, max_seq=args.max_seq)

    registration = members = None
    try:
        if args.serve_id:
            from oim_tpu_torch.serve.registration import ServeRegistration

            advertise = _advertise(args, server.addr)
            if args.shard > 1:
                # Member leases BEFORE the serve row's first beat, so the
                # row registers ready (its readiness folds in the census).
                from oim_tpu_torch.serve.members import ShardMembers

                members = ShardMembers(args.serve_id, args.shard, args.registry,
                                       interval=args.heartbeat, tls=tls)
                members.start()
                engine.set_member_watch(members.member_counts)
                log.info("member leases registered", shard=args.shard,
                         serve_id=args.serve_id)
            registration = ServeRegistration(
                args.serve_id, advertise, engine, args.registry,
                interval=args.heartbeat, tls=tls, version=args.weights_version)
            registration.start()
            log.info("registered in routing table", serve_id=args.serve_id,
                     advertise=advertise, heartbeat_s=args.heartbeat)
    except BaseException:
        engine.stop(drain=False)
        server.stop()
        obs.stop()
        raise

    export_stop = threading.Event()
    if args.kv_export:
        _start_exporter(engine, feeder, args.heartbeat, export_stop)
        log.info("kv chain exporter started", interval_s=args.heartbeat)

    telemetry_default = args.serve_id or (
        f"{args.controller_id}.serve" if args.controller_id else "")
    start_telemetry_row(obs, args.telemetry_id or telemetry_default, "serve",
                        args.registry, tls=tls)

    drained = threading.Event()

    def drain(*_):
        drained.set()  # signal-safe: the main thread acts on it

    signal.signal(signal.SIGTERM, drain)
    try:
        while not drained.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    log.info("draining", active=engine.active_slots, queued=engine.queue_len)
    export_stop.set()
    if registration is not None:
        # ready: false first, so routers rotate away while the residents
        # finish on their still-open streams.
        registration.announce_draining()
    engine.stop(drain=True, timeout=args.drain_timeout)
    if registration is not None:
        registration.stop(deregister=True)
    if members is not None:
        members.stop(deregister=True)
    server.stop()
    if feeder is not None:
        feeder.close()
    obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
