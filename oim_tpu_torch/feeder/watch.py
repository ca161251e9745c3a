"""The client half of the registry's Watch protocol
(``oim_tpu/registry/watch.py``'s ``WatchConsumer`` and event kinds,
copied): the feeder's address watch drives one Watch stream on a
controller's address key through it. The hub, the server half, stays in
the registry, which the port does not run.
"""

from __future__ import annotations

KIND_PUT = 1
KIND_DELETE = 2
KIND_EXPIRED = 3
KIND_SYNC = 4
KIND_RESET = 5

_KIND_LABEL = {KIND_PUT: "put", KIND_DELETE: "delete",
               KIND_EXPIRED: "expired", KIND_SYNC: "sync",
               KIND_RESET: "reset"}


class WatchConsumer:
    """The client half of the Watch protocol: one state machine shared
    by every consumer (the router's replica table, ``oimctl --top
    --watch``, the chaos watcher) instead of three hand-rolled copies.

    Drives one server stream through callbacks, owning the two pieces
    that are easy to get wrong:

    * **RESET..SYNC rebuilds**: PUTs between a RESET and its SYNC are
      collected and handed to ``install`` as one atomic batch — never
      patched into the live view.
    * **Resume-token discipline**: a token is committed to
      ``self.resume_token`` only once the view it describes is
      INSTALLED — per event for live deltas and token replays, at the
      SYNC for a snapshot. A stream that dies mid-snapshot therefore
      resumes from the PRE-snapshot token and re-triggers the full
      RESET, instead of replaying deltas onto a view that was never
      built (a deleted row would survive as a routable ghost).
    """

    def __init__(self):
        self.resume_token = ""

    def run(self, call, *, install, put, delete,
            on_reset=None, on_sync=None, is_stopped=None) -> None:
        """Consume ``call`` until it ends. ``install(dict path->value)``
        replaces the view; ``put(path, value)`` / ``delete(path,
        expired)`` patch it; ``on_sync()`` fires on every SYNC (view
        complete / keepalive). Raises whatever the stream raises."""
        resetting = False
        pending: dict[str, str] = {}
        for event in call:
            if is_stopped is not None and is_stopped():
                call.cancel()
                return
            kind = event.kind
            if kind == KIND_RESET:
                resetting, pending = True, {}
                if on_reset is not None:
                    on_reset()
            elif kind == KIND_SYNC:
                if resetting:
                    install(pending)
                    resetting = False
                if event.resume_token:
                    self.resume_token = event.resume_token
                if on_sync is not None:
                    on_sync()
            elif kind == KIND_PUT:
                if resetting:
                    pending[event.value.path] = event.value.value
                else:
                    put(event.value.path, event.value.value)
                    if event.resume_token:
                        self.resume_token = event.resume_token
            elif kind in (KIND_DELETE, KIND_EXPIRED):
                if not resetting:
                    delete(event.value.path, kind == KIND_EXPIRED)
                    if event.resume_token:
                        self.resume_token = event.resume_token
