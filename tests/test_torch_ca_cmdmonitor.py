"""The port's test CA (``oim_tpu_torch/common/ca.py``) and child-death
monitor (``common/cmdmonitor.py``) held against ``oim_tpu``'s on the CPU.

* Identities the port's CA issues (``user.admin``, ``component.registry``,
  ``host.<id>``, ``controller.<id>``) are accepted by a JAX registry and by
  a port one, each serving under the port CA's ``component.registry``
  certificate: the admin sets and reads through the port's ``oimctl``, a
  controller registers its own address, a host its own serve row.
* An admin-only ``--set`` made with a ``host.<id>`` certificate is refused
  by both registries, as is a request to write the reserved ``registry/``
  namespace.
* A certificate from a second, untrusted CA (the MITM matrix's "evil" CA)
  is refused by both registries, and a client that trusts only the evil CA
  refuses both registries.
* ``write_files`` makes JAX's file names; the certificates carry JAX's
  subject, issuer, SANs and extensions.
* ``monitored_popen``: killing the child fires ``died`` and the callback
  in both packages within the same bound; a normal exit fires them too; a
  caller's ``pass_fds`` is kept beside the monitor's pipe.
"""

from __future__ import annotations

import contextlib
import io
import os
import signal
import sys
import threading
import time

import grpc
import pytest
from cryptography import x509
from cryptography.x509.oid import NameOID

from oim_tpu.common import ca as jca
from oim_tpu.common import cmdmonitor as jcmdmonitor
from oim_tpu.common import logging as jlogging
from oim_tpu.registry import MemRegistryDB as JMemRegistryDB
from oim_tpu.registry import RegistryService as JRegistryService
from oim_tpu.registry.registry import registry_server as jregistry_server
from oim_tpu_torch.cli import oimctl
from oim_tpu_torch.common import ca
from oim_tpu_torch.common import cmdmonitor
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import tlsutil
from oim_tpu_torch.registry import MemRegistryDB, RegistryService
from oim_tpu_torch.registry.registry import registry_server
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub

IDENTITIES = ("user.admin", "component.registry", "host.host-0", "controller.host-0")


@pytest.fixture(autouse=True)
def quiet_loggers():
    jprev = jlogging.set_global(jlogging.Logger(level=jlogging.ERROR))
    tprev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    jlogging.set_global(jprev)
    tlogging.set_global(tprev)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """The port CA's identities, and an evil CA's admin in a directory of
    its own (with the evil CA's ca.crt)."""
    good, evil = tmp_path_factory.mktemp("good"), tmp_path_factory.mktemp("evil")
    authority = ca.CertAuthority()
    out = {cn: authority.write_files(good, cn) for cn in IDENTITIES}
    out["evil"] = ca.CertAuthority("evil-ca").write_files(evil, "user.admin")
    out["ca"], out["evil_ca"] = good / "ca.crt", evil / "ca.crt"
    return out


@pytest.fixture(scope="module", params=["port", "jax"])
def registry(request, certs):
    """One package's registry under mTLS, with the port CA's
    ``component.registry`` identity."""
    db, svc, serve = ((MemRegistryDB, RegistryService, registry_server)
                      if request.param == "port"
                      else (JMemRegistryDB, JRegistryService, jregistry_server))
    tls = tlsutil.load_tls(certs["ca"], certs["component.registry"])
    service = svc(db=db(), tls=tls)
    server = serve("tcp://127.0.0.1:0", service)
    yield server.addr, service
    server.stop()


def stub(certs, addr, identity, ca_file=None):
    tls = tlsutil.load_tls(ca_file or certs["ca"], certs[identity], "component.registry")
    channel = tlsutil.dial(addr, tls, "component.registry")
    return RegistryStub(channel), channel


def set_value(certs, addr, identity, path, value, ca_file=None):
    s, channel = stub(certs, addr, identity, ca_file)
    try:
        s.SetValue(pb.SetValueRequest(value=pb.Value(path=path, value=value)), timeout=10)
    finally:
        channel.close()


def oimctl_out(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert oimctl.main([*argv, "--log-level", "error"]) == 0
    return out.getvalue()


def test_the_ports_identities_are_accepted(certs, registry):
    addr, service = registry
    tls = ["--registry", addr, "--ca", str(certs["ca"])]
    oimctl_out([*tls, "--key", str(certs["user.admin"]), "--set", "admin-set/address=a:1"])
    set_value(certs, addr, "controller.host-0", "host-0/address", "127.0.0.1:9422")
    set_value(certs, addr, "host.host-0", "serve/host-0", '{"endpoint": "127.0.0.1:9460"}')
    for identity in IDENTITIES:
        s, channel = stub(certs, addr, identity)
        try:
            got = {v.path: v.value for v in s.GetValues(
                pb.GetValuesRequest(path=""), timeout=10).values}
        finally:
            channel.close()
        assert {"admin-set/address": "a:1", "host-0/address": "127.0.0.1:9422",
                "serve/host-0": '{"endpoint": "127.0.0.1:9460"}'}.items() <= got.items()
    assert oimctl_out([*tls, "--key", str(certs["user.admin"]), "--get", "host-0"]) == \
        "host-0/address=127.0.0.1:9422\n"


@pytest.mark.parametrize("path", ["host-0/mesh", "other/address", "registry/promote"])
def test_an_admin_only_set_with_a_host_identity_is_refused(certs, registry, path):
    addr, service = registry
    with pytest.raises(grpc.RpcError) as err:
        oimctl.main(["--registry", addr, "--ca", str(certs["ca"]), "--key",
                     str(certs["host.host-0"]), "--set", f"{path}=x", "--log-level", "error"])
    assert err.value.code() == grpc.StatusCode.PERMISSION_DENIED
    assert service.db.get(path) in (None, "")


@pytest.mark.parametrize("side", ["client_cert", "client_trust"])
def test_the_evil_cas_certificates_are_refused(certs, registry, side):
    """``client_cert``: the evil CA's admin certificate, presented to a
    registry that trusts the port CA. ``client_trust``: a client that
    trusts only the evil CA, dialing a registry of the port CA."""
    addr, service = registry
    identity, trust = (("evil", None) if side == "client_cert"
                       else ("user.admin", certs["evil_ca"]))
    with pytest.raises(grpc.RpcError) as err:
        set_value(certs, addr, identity, "evil/address", "x", ca_file=trust)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    assert service.db.get("evil/address") in (None, "")


def _cert_fields(pem: bytes) -> tuple:
    cert = x509.load_pem_x509_certificate(pem)
    return (cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)[0].value,
            cert.issuer.get_attributes_for_oid(NameOID.COMMON_NAME)[0].value,
            [(e.oid.dotted_string, e.critical, str(e.value)) for e in cert.extensions],
            cert.signature_hash_algorithm.name,
            (cert.not_valid_after_utc - cert.not_valid_before_utc).days)


def test_write_files_and_certificates_equal_jax(tmp_path):
    made = {}
    for name, mod in (("port", ca), ("jax", jca)):
        authority = mod.CertAuthority("oim-ca")
        d = tmp_path / name
        prefixes = [authority.write_files(d, "host.host-0"),
                    authority.write_files(d, "user.admin", basename="admin")]
        first_ca = (d / "ca.crt").read_bytes()
        authority.write_files(d, "controller.host-0")
        assert (d / "ca.crt").read_bytes() == first_ca == authority.cert_pem
        made[name] = {
            "files": sorted(p.name for p in d.iterdir()),
            "prefixes": [p.relative_to(d).as_posix() for p in prefixes],
            "ca": _cert_fields(authority.cert_pem),
            "issued": [_cert_fields((d / f"{b}.crt").read_bytes())
                       for b in ("host.host-0", "admin", "controller.host-0")],
        }
    assert made["port"] == made["jax"]
    assert made["port"]["files"] == [
        "admin.crt", "admin.key", "ca.crt", "controller.host-0.crt", "controller.host-0.key",
        "host.host-0.crt", "host.host-0.key"]
    assert made["port"]["prefixes"] == ["host.host-0", "admin"]


# --------------------------------------------------------------- monitor --

DEATH_BOUND_S = 5.0
PKGS = {"port": cmdmonitor, "jax": jcmdmonitor}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_killing_the_child_fires_died_and_the_callback(pkg):
    fired = threading.Event()
    proc, monitor = PKGS[pkg].monitored_popen(
        [sys.executable, "-c", "import time; time.sleep(60)"], on_death=fired.set)
    try:
        assert not monitor.died.wait(0.2)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGKILL)
        assert monitor.died.wait(DEATH_BOUND_S) and fired.wait(DEATH_BOUND_S)
        assert time.monotonic() - t0 < DEATH_BOUND_S
    finally:
        proc.kill()
        proc.wait(10)
    assert proc.returncode == -signal.SIGKILL


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_normal_exit_fires_them_too(pkg):
    fired = threading.Event()
    proc, monitor = PKGS[pkg].monitored_popen([sys.executable, "-c", "pass"],
                                              on_death=fired.set)
    assert proc.wait(30) == 0
    assert monitor.died.wait(DEATH_BOUND_S) and fired.wait(DEATH_BOUND_S)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_callers_pass_fds_is_kept(pkg):
    """The child writes to the caller's inherited fd (``pass_fds`` keeps
    its number), and the monitor's own pipe still reports the exit."""
    read_fd, write_fd = os.pipe()
    try:
        code = f"import os; os.write({write_fd}, b'from the child')"
        proc, monitor = PKGS[pkg].monitored_popen([sys.executable, "-c", code],
                                                  pass_fds=[write_fd])
        os.close(write_fd)
        write_fd = -1
        assert proc.wait(30) == 0
        assert os.read(read_fd, 64) == b"from the child"
        assert monitor.died.wait(DEATH_BOUND_S)
    finally:
        os.close(read_fd)
        if write_fd >= 0:
            os.close(write_fd)
