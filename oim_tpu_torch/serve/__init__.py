"""Serving (``oim_tpu/serve``): the packed-weights blob and the
continuous-batching engine over a paged KV cache.

* ``weights``     the ``OIMW0001`` blob (pack / unpack), publishing it as
  a volume and restoring a tree (or a member's) from the staged bytes.
* ``engine``      the slot-based continuous-batching scheduler: mid-flight
  admission, lockstep decode over a paged KV pool (``pagepool``), prompt
  prefix reuse (``prefixcache``) with a host-RAM tier (``kvtier``),
  bounded-queue backpressure and graceful drain; the prefill, decode and
  mixed roles.
* ``kvvolume``    the fleet tier: prefix chains as content-addressed
  ``OIMK0001`` volumes, exported at a prefill replica's retirement and
  adopted into a peer's page pool (``export_chain_to`` and ``ChainFetcher``
  need neither grpc nor protobuf).
* ``spec``        speculative decoding: acceptance math and the adaptive
  valve.
* ``shard``       tensor-parallel serving: one replica over several
  members, the Megatron split of the weights and the pool.

The gRPC half, which needs grpcio and protobuf and is imported from its
modules: ``service`` (``oim.v1.Serve``), ``registration`` (the
``serve/<id>`` row) and ``members`` (a sharded replica's member leases).
"""

from oim_tpu_torch.serve.engine import (  # noqa: F401
    Draining,
    GenHandle,
    QueueFull,
    ServeEngine,
)
from oim_tpu_torch.serve.pagepool import PagePool  # noqa: F401
from oim_tpu_torch.serve.spec import AcceptanceValve, accept_tokens  # noqa: F401
from oim_tpu_torch.serve.weights import pack_params, unpack_params  # noqa: F401
