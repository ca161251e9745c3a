"""The controller (``oim_tpu/controller``): backends that stage volumes
into host memory (``MallocBackend``) or a CUDA device (``CUDABackend``),
with the content-addressed stage cache, and ``backend.read_window``, the
data window. The gRPC ``Controller``/``ControllerService`` are in
``controller.controller``, imported from there: this package loads
without grpcio and protobuf, as the card machine needs."""

from oim_tpu_torch.controller.backend import StagedVolume, StageState, StagingBackend
from oim_tpu_torch.controller.cuda_backend import CUDABackend
from oim_tpu_torch.controller.malloc_backend import MallocBackend
from oim_tpu_torch.controller.stagecache import StageCache

__all__ = ["CUDABackend", "MallocBackend", "StageCache", "StageState", "StagedVolume",
           "StagingBackend"]
