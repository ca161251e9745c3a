"""Identity/Probe service (``oim_tpu/common/identity.py``): name,
version, capability discovery.

Every long-running component (the controller) serves this next to its
main service on the same endpoint, so consumers can negotiate what a
component supports (staging backend, data sources) before using it.
"""

from __future__ import annotations

from typing import Callable, Iterable

import oim_tpu_torch
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import IdentityServicer


class IdentityService(IdentityServicer):
    def __init__(
        self,
        name: str,
        capabilities: Iterable[str] = (),
        ready_fn: Callable[[], bool] | None = None,
        version: str | None = None,
    ):
        self.name = name
        self.capabilities = sorted(capabilities)
        self.ready_fn = ready_fn or (lambda: True)
        self.version = version or oim_tpu_torch.__version__

    def GetInfo(self, request, context):
        return pb.GetInfoReply(
            name=self.name,
            version=self.version,
            capabilities=self.capabilities,
        )

    def Probe(self, request, context):
        return pb.ProbeReply(ready=bool(self.ready_fn()))
