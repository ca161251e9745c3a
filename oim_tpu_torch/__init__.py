"""oim-tpu ported to PyTorch and CUDA on an NVIDIA H100.

The package mirrors ``oim_tpu``'s layout (``ops/``, ``models/``,
``train/``, ``cli/``) and adds ``kernels/``: the hand-written Hopper
kernels that replace the JAX package's Pallas kernels, with their loader.
It imports torch and numpy, never JAX and nothing of ``oim_tpu``; its
gRPC surface (``spec.oim_pb2``, ``spec.services``, the controller
service, the feeder) also imports grpcio and protobuf, and nothing on the
training and serving path imports that surface.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor each kernel wrapper runs the kernel's plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
