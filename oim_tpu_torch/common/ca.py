"""In-process certificate authority for mTLS identities.

The reference generates its CA hierarchy with test/setup-ca.sh and encodes
identity + authorization role in the certificate CommonName
(README.md:173-213): ``user.admin``, ``component.registry``, ``host.<id>``,
``controller.<id>``. This module does the same with the ``cryptography``
package so tests can build a real CA (and a deliberately untrusted "evil" CA
for the MITM matrix, README.md:558-563) without shelling out to openssl.

Files written by ``write_files`` follow the reference's ``<name>.key`` /
``<name>.crt`` basename convention (pkg/oim-common/grpc.go:131-137).
"""

from __future__ import annotations

import datetime
import ipaddress
from pathlib import Path

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

_ONE_DAY = datetime.timedelta(days=1)


def _name(common_name: str) -> x509.Name:
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])


class CertAuthority:
    """A self-signed CA that can issue identity certificates."""

    def __init__(self, name: str = "oim-ca"):
        self.name = name
        self._key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        self._cert = (
            x509.CertificateBuilder()
            .subject_name(_name(name))
            .issuer_name(_name(name))
            .public_key(self._key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + 365 * _ONE_DAY)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
            .sign(self._key, hashes.SHA256())
        )

    @property
    def cert_pem(self) -> bytes:
        return self._cert.public_bytes(serialization.Encoding.PEM)

    def issue(self, common_name: str) -> tuple[bytes, bytes]:
        """Issue (key_pem, cert_pem) for an identity.

        The CommonName is also set as a DNS SAN so python-gRPC's hostname
        check (driven by ssl_target_name_override) can pin the peer identity
        the way the reference's VerifyPeerCertificate does
        (pkg/oim-common/grpc.go:77-127). localhost/127.0.0.1 SANs are included
        for loopback test servers.
        """
        key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(_name(common_name))
            .issuer_name(_name(self.name))
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + 365 * _ONE_DAY)
            .add_extension(
                x509.SubjectAlternativeName(
                    [
                        x509.DNSName(common_name),
                        x509.DNSName("localhost"),
                        x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                    ]
                ),
                critical=False,
            )
            .sign(self._key, hashes.SHA256())
        )
        key_pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )
        return key_pem, cert.public_bytes(serialization.Encoding.PEM)

    def write_files(self, directory: str | Path, common_name: str,
                    basename: str | None = None) -> Path:
        """Write <basename>.key/.crt (plus ca.crt) and return the key prefix path."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        basename = basename or common_name
        key_pem, cert_pem = self.issue(common_name)
        (directory / f"{basename}.key").write_bytes(key_pem)
        (directory / f"{basename}.crt").write_bytes(cert_pem)
        ca_path = directory / "ca.crt"
        if not ca_path.exists():
            ca_path.write_bytes(self.cert_pem)
        return directory / basename
