"""The chaos ladder's ``autoscale`` rung (``oim_tpu_torch/chaos/ladder.py``)
converging on the CPU over the port's registry, router, engines, SLO
monitor and two autoscalers, as tests/test_chaos.py's rung does over
JAX's: a one-slot fleet saturated by routed load fires the first-token
SLO, the leader scales up through the sim's launcher and dies mid-episode,
the standby takes the fleet row over with the raised target, and the
resolve decays the fleet back down.

The rung's signature is JAX's, in order; its report shows zero client
errors, every routed stream equal to the port's solo ``generate()``, the
takeover by the standby with ``adopted_target >= 2``, and a clean census.
Its events land in the port's ring and none in JAX's.
"""

from __future__ import annotations

import time

import pytest
import torch

from oim_tpu.chaos import ladder as jladder
from oim_tpu.common import events as jevents
from oim_tpu_torch.chaos import ladder

torch.set_num_threads(2)

SIGNATURE = ["slo_alert_fired", "autoscale_scale_up", "autoscale_takeover",
             "slo_alert_resolved", "autoscale_scale_down"]


@pytest.fixture(autouse=True, scope="module")
def _watch_streams_end():
    """The registry's Watch handlers notice a stopped server at their next
    keepalive (2 s): wait them out, so no RPC of this file counts into a
    later one's metrics."""
    yield
    time.sleep(2.5)


def test_autoscale_rung_converges_with_jax_signature():
    [jrung] = [r for r in jladder.RUNGS if r.name == "autoscale"]
    assert list(jrung.expect) == SIGNATURE
    jcounts = jevents.recorder().counts()
    report = ladder.run_ladder(names=["autoscale"], device="cpu")
    [rung] = report["rungs"]
    assert report["event_signature"] == [["autoscale", *SIGNATURE]]
    assert rung["healed"] == SIGNATURE
    details = rung["details"]
    assert details["takeover_by"] == "as-b"
    assert details["scale_ups"] >= 1
    assert details["byte_identical"] == details["requests"] > 0
    assert rung["census"]["replicas"], rung
    for row in rung["census"]["replicas"].values():
        assert not (row["active_slots"] or row["queued"] or row["used_pages"]), row
    assert {t: jevents.recorder().counts().get(t, 0) for t in SIGNATURE} == \
        {t: jcounts.get(t, 0) for t in SIGNATURE}
