"""The body of a ``telemetry/<id>`` row (``metrics_snapshot``, JAX's
``oim_tpu/common/telemetry.py``), in a module that imports no grpc.

``common/telemetry.py`` publishes the row over gRPC and re-exports this
function; the SLO engine (``obs/slo.py``) folds the body. Both halves of
the SLO plane's decision (the snapshot a serving process takes and the
engine that reads it) therefore load where grpcio is not installed.
"""

from __future__ import annotations


def metrics_snapshot() -> dict:
    """The fleet-mergeable metrics payload a telemetry row carries each
    beat (oim_tpu/obs/merge.py snapshot format): cumulative bucket
    snapshots of the latency histograms the SLO plane merges, plus the
    ``requests_total{outcome}`` counters the availability SLO needs.

    Every daemon publishes ``rpc`` (the interceptors record it on every
    process); the serve-side series ride only when they have
    observations (a router's zero first-token histogram is dead weight
    in every heartbeat, and absence is what keeps non-serving roles'
    rows small). A pre-upgrade daemon simply publishes no ``hist`` at
    all — consumers dash-degrade (the mixed-version stance).

    The ``rpc`` series EXCLUDES the registry row-renewal methods
    (SetValue / Heartbeat): the publisher's own beat records an RPC
    latency sample, so including them would make every snapshot differ
    from the last and silently demote every value-stable row from
    batched Heartbeat renewal back to publish-every-beat — the
    instrument observing itself. The data-path methods the RPC SLO
    cares about (Generate, ReadVolume, Watch, MapVolume, ...) all
    ride."""
    from oim_tpu_torch.common import metrics as M

    renewal = {"oim.v1.Registry/SetValue", "oim.v1.Registry/Heartbeat"}
    hist = {
        "rpc": M.RPC_LATENCY.merged_snapshot(
            skip=lambda labels: labels.get("method") in renewal),
    }
    for key, family, labels in (
            ("first_token", M.SERVE_TOKEN_LATENCY, {"kind": "first"}),
            ("inter_token", M.SERVE_TOKEN_LATENCY, {"kind": "next"}),
            ("queue_wait", M.SERVE_QUEUE_WAIT, None),
    ):
        snap = family.merged_snapshot(labels)
        if snap["counts"][-1] > 0:
            hist[key] = snap
    payload: dict = {"hist": hist}
    requests = {
        key[0]: value
        for key, value in M.SERVE_REQUESTS_TOTAL.labeled_values().items()
        if value > 0
    }
    if requests:
        payload["counters"] = {"requests_total": requests}
    return payload
