"""Deterministic fault injection (``oim_tpu/common/faultinject.py``).
The gRPC-status fault that module also defines, ``InjectedRpcError``,
is in ``common/rpcfault.py``, so this module loads without grpcio.

Production code calls ``fire(point, **ctx)`` at named fault points, which
is a no-op until a test arms the point. Faults are DETERMINISTIC, armed
with an exact count and an optional context match, so tests assert
recovery behavior and never race a random fault schedule.

Named points wired in the port:

* ``controller.heartbeat`` — before the controller's Heartbeat RPC (ctx:
  controller_id). Arming it simulates heartbeats lost on the wire.
* ``controller.register`` — before ``register_once``'s SetValue calls
  (ctx: controller_id). Arming it simulates a registry outage.
* ``feeder.rpc`` — before each remote feeder data-plane RPC (ctx:
  controller_id, method). Arming it simulates a controller that accepted
  the publish and then froze.
* ``prestage.fanout`` — before the feeder's warm-standby PrestageVolume
  RPC (ctx: volume, target). Absorbed: warming is advisory.
* ``serve.admit``  — in ``ServeEngine.submit`` before the queue (ctx:
  engine). Arm a ``QueueFull``/``Draining`` instance to simulate admission
  refusal; an injected ``QueueFull`` counts as rejected.
* ``serve.decode`` — at the top of each decode round (ctx: engine).
  Arming it wedges the engine: the loop's catch-all fails every request
  and the engine stops admitting.
* ``serve.retire`` — before a retiring slot releases its pages (ctx:
  engine, reason). Arming it crashes the engine AT retirement; the
  failure teardown still returns every page.
* ``spec.propose`` — in the draft-slot mapping (ctx: engine). An armed
  ``InjectedFault`` is absorbed as a draft-pool allocation failure: the
  request demotes to plain decode, never errors.

All state is process-global; a ``fire`` on an unarmed point costs one
dict lookup.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any


class InjectedFault(Exception):
    """Raised at an armed fault point (when no custom exc is supplied)."""


@dataclass
class _Fault:
    exc: BaseException | type[BaseException]
    times: int | None  # None = until disarmed
    match: dict[str, Any] = field(default_factory=dict)
    fired: int = 0


_faults: dict[str, _Fault] = {}
_lock = threading.Lock()


def arm(point: str, *, exc: BaseException | type[BaseException] | None = None,
        times: int | None = None, **match: Any) -> None:
    """Arm ``point``: the next ``times`` matching ``fire`` calls raise
    ``exc`` (default InjectedFault). ``match`` keys must equal the
    ``fire`` context for the fault to trigger; non-matching calls pass
    through untouched (and don't consume ``times``)."""
    with _lock:
        _faults[point] = _Fault(
            exc=exc if exc is not None else InjectedFault(point),
            times=times, match=dict(match),
        )


def disarm(point: str) -> None:
    with _lock:
        _faults.pop(point, None)


def reset() -> None:
    """Disarm everything (test-fixture teardown)."""
    with _lock:
        _faults.clear()


def fired(point: str) -> int:
    """How many times ``point`` has triggered since it was armed."""
    with _lock:
        fault = _faults.get(point)
        return fault.fired if fault else 0


def fire(point: str, **ctx: Any) -> None:
    """Production-code hook: raise if ``point`` is armed and ``ctx``
    matches. No-op (one dict lookup) otherwise.

    A fault armed with an exception INSTANCE and ``times != 1`` is
    re-instantiated per fire (``type(exc)(*exc.args)``): raising one
    shared instance from several threads concurrently mutates its
    ``__traceback__`` under every raiser at once. ``times=1`` keeps the
    caller's exact object (tests assert identity on it); an exception
    that cannot be rebuilt from its args falls back to the shared
    instance."""
    with _lock:
        fault = _faults.get(point)
        if fault is None:
            return
        if any(ctx.get(k) != v for k, v in fault.match.items()):
            return
        if fault.times is not None:
            if fault.fired >= fault.times:
                return
        fault.fired += 1
        exc = fault.exc
        per_fire = not isinstance(exc, type) and fault.times != 1
    if isinstance(exc, type):
        raise exc(point)
    if per_fire:
        try:
            exc = type(exc)(*exc.args)
        except Exception:  # noqa: BLE001 - unreconstructable: shared
            pass
    raise exc
