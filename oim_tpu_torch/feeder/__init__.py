"""The feeder (``oim_tpu/feeder``): publishes staged volumes to consumers.

``Feeder.publish`` is MapVolume (in process to a local
``ControllerService``, or through the registry's proxy to a remote
controller) plus the wait until the volume is staged; ``fetch`` and
``fetch_window`` read it back. ``FeederDaemon`` and ``feeder_server``
(``feeder/service.py``) serve it as ``oim.v1.Feeder``, the daemon of
``cli/oim_feeder.py``. The package needs grpcio and protobuf; the trainer
imports it only under ``--registry``.
"""

from oim_tpu_torch.feeder.driver import Feeder, PublishedVolume  # noqa: F401
from oim_tpu_torch.feeder.emulation import (  # noqa: F401
    emulations,
    map_volume_params,
    register_emulation,
)
from oim_tpu_torch.feeder.service import FeederDaemon, feeder_server  # noqa: F401
