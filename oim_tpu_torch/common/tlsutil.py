"""mTLS configuration with CommonName-encoded identity and authorization.

Re-creates the reference's scheme (pkg/oim-common/grpc.go:43-137,
README.md:173-213): every component has a certificate whose CommonName encodes
its identity and role (``user.admin``, ``component.registry``, ``host.<id>``,
``controller.<id>``); both sides of every connection verify the peer chains to
the shared CA *and* pin the expected peer name.

* Client -> server pinning uses gRPC's ``grpc.ssl_target_name_override``
  channel arg (the Python analog of the reference's tls.Config.ServerName +
  VerifyPeerCertificate, grpc.go:96-126).
* Server -> client identity extraction uses ``peer_common_name`` on the
  servicer context; authorization decisions live in the registry
  (oim_tpu/registry/registry.py), mirroring registry.go:67-109.

The port's copy of ``oim_tpu/common/tlsutil.py``; it imports nothing of
that package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import grpc

# Ceiling for one gRPC message on every oim channel and server (gRPC's
# stock default is 4 MiB). Sized so a ReadVolume chunk at the
# controller's MAX_READ_CHUNK (16 MiB) plus first-chunk framing (spec +
# total_bytes) clears it with room: big windows stream in a few large
# messages instead of dozens of 3 MiB ones.
GRPC_MAX_MESSAGE_BYTES = 32 << 20

_MESSAGE_SIZE_OPTIONS = [
    ("grpc.max_send_message_length", GRPC_MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE_BYTES),
]


@dataclasses.dataclass(frozen=True)
class TLSConfig:
    """Loaded PEM material plus the expected peer name for outgoing dials."""

    ca_pem: bytes
    key_pem: bytes
    cert_pem: bytes
    peer_name: str = ""


def load_tls(ca_file: str | Path, key_prefix: str | Path, peer_name: str = "") -> TLSConfig:
    """Load ``<key_prefix>.key`` / ``<key_prefix>.crt`` + CA file (reference
    LoadTLS, grpc.go:131-137)."""
    # Append (not Path.with_suffix, which would eat a dotted CN like
    # "component.registry"): the reference appends ".key"/".crt" to the full
    # basename (grpc.go:131-137).
    prefix = str(key_prefix)
    return TLSConfig(
        ca_pem=Path(ca_file).read_bytes(),
        key_pem=Path(prefix + ".key").read_bytes(),
        cert_pem=Path(prefix + ".crt").read_bytes(),
        peer_name=peer_name,
    )


def server_credentials(cfg: TLSConfig) -> grpc.ServerCredentials:
    """Server-side mTLS: present our cert, require + verify client certs."""
    return grpc.ssl_server_credentials(
        [(cfg.key_pem, cfg.cert_pem)],
        root_certificates=cfg.ca_pem,
        require_client_auth=True,
    )


def channel_credentials(cfg: TLSConfig) -> grpc.ChannelCredentials:
    return grpc.ssl_channel_credentials(
        root_certificates=cfg.ca_pem,
        private_key=cfg.key_pem,
        certificate_chain=cfg.cert_pem,
    )


def dial_options(peer_name: str) -> list[tuple[str, object]]:
    """Channel args: peer-identity pinning (reference ChooseDialOpts +
    ServerName, grpc.go:43-67,96-99) plus the raised message-size caps
    every oim channel carries (big ReadVolume chunks)."""
    options: list[tuple[str, object]] = list(_MESSAGE_SIZE_OPTIONS)
    if peer_name:
        options.append(("grpc.ssl_target_name_override", peer_name))
    return options


def secure_channel(address: str, cfg: TLSConfig, peer_name: str | None = None) -> grpc.Channel:
    """Dial with mTLS and peer-name pinning; ``peer_name`` defaults to
    ``cfg.peer_name``."""
    name = cfg.peer_name if peer_name is None else peer_name
    return grpc.secure_channel(
        address, channel_credentials(cfg), options=dial_options(name)
    )


def dial(address: str, tls: TLSConfig | None, peer_name: str = "") -> grpc.Channel:
    """The one way every component dials another: mTLS with peer-name pinning
    when TLS material is configured, plain channel otherwise (tests only).
    Every channel carries the telemetry client interceptor (spans with
    ``oim-trace`` propagation + labeled RPC metrics, common/rpctelemetry.py)."""
    from oim_tpu_torch.common.rpctelemetry import TelemetryClientInterceptor

    if tls is not None:
        channel = secure_channel(address, tls, peer_name or tls.peer_name)
    else:
        channel = grpc.insecure_channel(address, options=dial_options(""))
    return grpc.intercept_channel(channel, TelemetryClientInterceptor())


def peer_common_name(context: grpc.ServicerContext) -> str | None:
    """Extract the verified client CommonName from a servicer context
    (reference getPeer, pkg/oim-registry/registry.go:67-82). Returns None for
    insecure or unauthenticated peers."""
    auth = context.auth_context()
    for key in ("x509_common_name",):
        vals = auth.get(key)
        if vals:
            return vals[0].decode()
    return None
