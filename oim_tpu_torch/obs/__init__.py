"""Fleet SLO plane: cluster-wide histogram merge, burn-rate alerting,
and per-request latency autopsy.

PR 8 gave every daemon a flight recorder and a scrapeable /metrics; the
registry's telemetry rows made the fleet discoverable. This package adds
the *aggregate* layer on top, control-plane style (PAPER.md §0: control
traffic rides the registry, never a new scrape hot path):

* ``merge``   — the mergeable-histogram algebra: serializable bucket
  snapshots (shared ``le`` grid, cumulative counts + sum) that fold
  across N replicas with counter-reset epoch detection, so per-replica
  p99s become one true fleet p99.
* ``slo``     — declared SLOs evaluated as Google-SRE multi-window burn
  rates (fast/slow), with per-episode alert debounce + resolve
  hysteresis.
* ``monitor`` — the ``oim-monitor`` daemon's core: ONE Watch stream on
  the ``telemetry/`` prefix (GetValues poll as the mixed-version
  fallback) feeding the SLO engine, firing alerts as TTL-leased
  ``alert/<name>`` registry rows — the exact input a future autoscaler
  consumes.
* ``autopsy`` — per-request latency autopsy: fan out to the fleet's
  ``/debug/spans`` + ``/debug/events`` and render one phase-attributed
  timeline for a trace_id, unattributed gap time called out.

Everything here is pure stdlib (no jax, no grpc at import time in
``merge``/``slo``/``autopsy``), so ``oimctl`` can import it for the
``--top`` fleet row and ``--autopsy`` without touching the model stack.
"""

from oim_tpu_torch.obs import autopsy, merge, slo  # noqa: F401

__all__ = ["autopsy", "merge", "slo"]
