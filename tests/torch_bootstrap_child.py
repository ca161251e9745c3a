"""A rank of tests/test_torch_bootstrap.py's two-process run: the port's
trainer assembled from the registry, with its own controller in this
process.

It starts a port controller daemon (``oim_controller.build``: a
``CUDABackend`` on the CPU, registered as ``--controller-id`` at
``--mesh-coord``) and joins the process group through the trainer CLI's
``join`` (``--registry --expected-hosts 2 --coordinator-port``: the rank
comes from the registry). Then, on that group:

1. sharded staging, as JAX's ``mh_sharded_staging_child.py`` does it:
   the volume is published to this controller as [n, batch, seq + 1]
   with its batch dim over the trainer's data=2 mesh, so the plane reads
   only this rank's rows of every batch, and a ``Trainer`` takes its
   steps on the placed batches;
2. the trainer CLI itself (``oim_trainer.run``): the volume fed through
   the registry's proxy to this controller, read whole by each rank.

JAX's initial weights are read from ``--init`` (an .npz of "a.b" keys).
The rank, both runs' histories and the bytes the plane read in (1) go to
``--out`` as JSON.

    python tests/torch_bootstrap_child.py --registry HOST:PORT \\
        --controller-id host-0 --mesh-coord 1,0,0 --coordinator-port P \\
        --volume-file tokens.npy --init init.npz --out rank.json [trainer flags]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import socket
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    for flag in ("--registry", "--controller-id", "--mesh-coord", "--coordinator-port",
                 "--volume-file", "--init", "--out"):
        ap.add_argument(flag, required=True)
    args, trainer_flags = ap.parse_known_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from oim_tpu_torch.cli import oim_controller, oim_trainer
    from oim_tpu_torch.data import plane
    from oim_tpu_torch.feeder import Feeder
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.spec import oim_pb2 as pb
    from oim_tpu_torch.train import trainer as ttrainer
    from tests.torch_parallel_worker import unflatten

    port = free_port()
    controller, server = oim_controller.build(oim_controller.parse_args([
        "--controller-id", args.controller_id, "--endpoint", f"tcp://127.0.0.1:{port}",
        "--controller-address", f"127.0.0.1:{port}", "--registry", args.registry,
        "--registry-delay", "1", "--mesh-coord", args.mesh_coord, "--backend", "cuda",
        "--device", "cpu", "--log-level", "error"]))
    init = unflatten(dict(np.load(args.init)))
    orig = ttrainer.Trainer.init

    def init_from_jax(self, params=None, extra=None):
        orig(self, llama.from_numpy(init, device="cpu") if params is None else params, extra)

    ttrainer.Trainer.init = init_from_jax
    rank_of = {}
    init_group = dist.init_process_group

    def seen(*a, **kw):
        rank_of.update(rank=kw["rank"], world=kw["world_size"],
                       init_method=kw["init_method"])
        return init_group(*a, **kw)

    dist.init_process_group = seen
    argv = ["--registry", args.registry, "--controller-id", args.controller_id,
            "--expected-hosts", "2", "--coordinator-port", args.coordinator_port,
            "--volume-file", args.volume_file, "--device", "cpu", *trainer_flags]
    cli = oim_trainer.parse_args(argv)
    device, made = oim_trainer.join(cli)
    out = dict(rank_of)
    try:
        # 1. the volume staged over the trainer's mesh, this rank's rows only
        cfg = oim_trainer.config_from_args(cli)
        trainer = ttrainer.Trainer(cfg, device=device, axes=oim_trainer.parse_mesh(cli.mesh))
        backend = controller.service.backend
        # The mesh exists once the ranks have joined, which is after the
        # controller registered (the join waits for its row).
        backend.mesh = trainer.mesh
        read = {"bytes": 0}
        file_reader = plane.READERS["file"]

        def counted(locator, offset, length, dst, headers, **kw):
            read["bytes"] += length
            return file_reader(locator, offset, length, dst, headers, **kw)

        plane.READERS["file"] = counted
        try:
            pub = Feeder(controller=controller.service).publish(pb.MapVolumeRequest(
                volume_id="placed", file=pb.FileParams(path=args.volume_file, format="npy"),
                spec=pb.ArraySpec(shape=[-1, cfg.batch_size, cfg.seq_len + 1],
                                  sharding_axes=["", "data", ""])), timeout=60)
        finally:
            plane.READERS["file"] = file_reader
            backend.mesh = None
        placed = pub.array
        trainer.run(steps=cli.steps, data=({"tokens": placed[i % placed.shape[0]]}
                                           for i in itertools.count()))
        out["placed"] = {"history": trainer.history, "bytes_read": read["bytes"],
                         "is_placed": isinstance(placed, plane.Placed),
                         "local_rows": list(placed.local.shape)}
        # 2. the trainer CLI on the same group, fed through the registry
        out["cli"] = {"history": oim_trainer.run(argv).history}
        dist.barrier()
    finally:
        if made:
            dist.destroy_process_group()
        controller.stop()
        server.force_stop()
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
