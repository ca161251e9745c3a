"""Emulation plug-in registry (``oim_tpu/feeder/emulation.py``, copied):
translate third-party dataset/volume descriptors into MapVolume requests.

Same compile-time extension pattern as the reference's EmulateCSIDriver
registry (pkg/oim-csi-driver/oim-driver.go:55-65, ceph-csi.go:34-108): each
personality contributes a translator from its own attribute/secret dictionaries
to an ``oim.v1.MapVolumeRequest``; personalities register themselves at import
into a module-level map and are selected by name.
"""

from __future__ import annotations

from typing import Callable, Mapping

from oim_tpu_torch.spec import oim_pb2 as pb

Translator = Callable[[str, Mapping[str, str], Mapping[str, str]], pb.MapVolumeRequest]

_REGISTRY: dict[str, Translator] = {}


def register_emulation(name: str, translator: Translator) -> None:
    _REGISTRY[name] = translator


def emulations() -> list[str]:
    return sorted(_REGISTRY)


def map_volume_params(
    emulate: str,
    volume_id: str,
    attributes: Mapping[str, str],
    secrets: Mapping[str, str] | None = None,
) -> pb.MapVolumeRequest:
    try:
        translator = _REGISTRY[emulate]
    except KeyError:
        raise ValueError(
            f"unknown emulation {emulate!r}; have {emulations()}"
        ) from None
    return translator(volume_id, attributes, secrets or {})


# -- built-in personalities ----------------------------------------------


def _ceph_csi(volume_id, attributes, secrets) -> pb.MapVolumeRequest:
    """ceph-csi parity: extract pool/monitors/user/secret from volume
    attributes + publish secrets (reference ceph-csi.go:51-108)."""
    try:
        monitors = attributes["monitors"]
        pool = attributes["pool"]
    except KeyError as err:
        raise ValueError(f"ceph-csi attributes missing {err}") from None
    user = attributes.get("adminid") or attributes.get("userid") or "admin"
    key = secrets.get(user) or secrets.get("key", "")
    return pb.MapVolumeRequest(
        volume_id=volume_id,
        ceph=pb.CephParams(
            monitors=monitors,
            user=user,
            secret=key,
            pool=pool,
            image=attributes.get("image", volume_id),
        ),
    )


def _tfrecord(volume_id, attributes, secrets) -> pb.MapVolumeRequest:
    paths = attributes["paths"].split(",")
    req = pb.MapVolumeRequest(
        volume_id=volume_id, tfrecord=pb.TFRecordParams(paths=paths)
    )
    if "shape" in attributes:
        req.spec.shape.extend(int(d) for d in attributes["shape"].split(","))
    req.spec.dtype = attributes.get("dtype", "uint8")
    return req


def _webdataset(volume_id, attributes, secrets) -> pb.MapVolumeRequest:
    urls = attributes["shard_urls"].split(",")
    return pb.MapVolumeRequest(
        volume_id=volume_id, webdataset=pb.WebDatasetParams(shard_urls=urls)
    )


register_emulation("ceph-csi", _ceph_csi)
register_emulation("tfrecord", _tfrecord)
register_emulation("webdataset", _webdataset)
