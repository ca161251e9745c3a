"""The oim-tpu registry: cluster topology KV store + transparent mTLS gRPC proxy.

TPU-native counterpart of the reference's pkg/oim-registry (SURVEY.md section 2.4):
the registry is the source of truth for slice topology (controller ID -> DCN
address + ICI mesh coordinate) from which trainer meshes are built, and proxies
controller-bound RPCs so compute nodes never need direct connectivity to TPU
hosts.
"""

from oim_tpu_torch.registry.db import FileRegistryDB, MemRegistryDB, RegistryDB  # noqa: F401
from oim_tpu_torch.registry.leases import LeaseTable  # noqa: F401
from oim_tpu_torch.registry.registry import RegistryService, registry_server  # noqa: F401
from oim_tpu_torch.registry.replication import (  # noqa: F401
    HealthzServer,
    ReplicationManager,
)
