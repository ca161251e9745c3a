"""The actuation seam: how reconcile actions become running replicas.

The reconciler (reconcile.py) decides WHAT; a ``ReplicaLauncher``
decides HOW. Two implementations ship:

* ``SubprocessLauncher`` — real deployments: spawn = fork an
  ``oim-serve`` process (prestage hook first, so the boot's weights
  publish is an O(1) stage-cache hit), drain = SIGTERM, riding
  oim-serve's existing graceful-drain contract (announce ready:false,
  finish residents, deregister).
* the chaos sim's ``SimReplicaLauncher`` (chaos/sim.py) — tests: spawn
  boots a ``ReplicaHandle`` inside the in-process cluster, drain runs
  the same SIGTERM-shaped drain path without a process to signal.

Both are fire-and-forget on purpose: ``spawn()`` returns the replica id
immediately and the boot proceeds in the background — the reconcile
loop must keep ticking (and a standby's leader gate keep refreshing)
while a replica compiles its first prefill. The daemon learns the
outcome the same way routers do: the replica's own ``serve/<id>``
heartbeat appearing (or not) in the registry.
"""

from __future__ import annotations

import itertools
import signal
import subprocess
import sys
import threading

from oim_tpu_torch.common.logging import from_context


class ReplicaLauncher:
    """The protocol reconcile actions are executed through."""

    def prestage(self, version: str) -> None:
        """Warm the weights for ``version`` fleet-wide (best-effort;
        called before the first spawn of each version so boots hit the
        stage cache instead of re-reading source bytes)."""
        raise NotImplementedError

    def spawn(self, version: str) -> str:
        """Start one replica serving ``version`` ("" = unversioned);
        returns its replica id immediately, boot continues async."""
        raise NotImplementedError

    def drain(self, replica_id: str) -> None:
        """Gracefully drain one replica (SIGTERM contract: ready:false
        first, residents finish, deregister)."""
        raise NotImplementedError


class SubprocessLauncher(ReplicaLauncher):
    """Spawn/drain real ``oim-serve`` processes.

    ``base_args`` is everything a replica needs except its identity and
    version (weights source, registry, controller id, TLS, sizing) —
    the operator writes it once, the launcher appends ``--serve-id``
    and ``--weights-version`` per spawn. ``version_args`` maps a
    version to the extra flags that select its weights (typically
    ``["--weights-volume", "weights-v2", "--restore-only"]``);
    ``prestage_argv`` is an optional command template run once per new
    version before its first spawn (``{version}`` is substituted) —
    usually an ``oimctl``/feeder invocation that publishes + PrestageVolume
    fan-outs the new volume while the old version still serves.
    """

    def __init__(
        self,
        base_args: list[str],
        serve_id_prefix: str = "auto",
        version_args: dict[str, list[str]] | None = None,
        prestage_argv: list[str] | None = None,
        python: str = sys.executable,
    ):
        self.base_args = list(base_args)
        self.serve_id_prefix = serve_id_prefix
        self.version_args = dict(version_args or {})
        self.prestage_argv = list(prestage_argv or [])
        self.python = python
        self._seq = itertools.count()
        self._procs: dict[str, subprocess.Popen] = {}
        self._prestaged: set[str] = set()
        self._lock = threading.Lock()

    def prestage(self, version: str) -> None:
        if not self.prestage_argv or version in self._prestaged:
            return
        argv = [a.replace("{version}", version) for a in self.prestage_argv]
        log = from_context()
        try:
            subprocess.run(argv, check=True, capture_output=True,
                           timeout=600)
            self._prestaged.add(version)
            log.info("prestaged weights version", version=version)
        except (OSError, subprocess.SubprocessError) as err:
            # Best-effort by contract: a failed prestage costs the boot
            # a cache miss, never the fleet a replica.
            log.warning("weights prestage failed", version=version,
                        error=repr(err))

    def spawn(self, version: str) -> str:
        self.prestage(version)
        replica_id = f"{self.serve_id_prefix}-{next(self._seq)}"
        argv = [self.python, "-m", "oim_tpu_torch.cli.oim_serve",
                *self.base_args, "--serve-id", replica_id]
        if version:
            argv += ["--weights-version", version,
                     *self.version_args.get(version, [])]
        proc = subprocess.Popen(argv)  # noqa: S603 - operator-declared argv
        with self._lock:
            self._reap_locked()
            self._procs[replica_id] = proc
        from_context().info("spawned replica", replica=replica_id,
                            version=version, pid=proc.pid)
        return replica_id

    def drain(self, replica_id: str) -> None:
        with self._lock:
            proc = self._procs.get(replica_id)
        log = from_context()
        if proc is None or proc.poll() is not None:
            log.warning("drain target not running", replica=replica_id)
            return
        proc.send_signal(signal.SIGTERM)
        log.info("draining replica", replica=replica_id, pid=proc.pid)

    def _reap_locked(self) -> None:
        for rid in [r for r, p in self._procs.items()
                    if p.poll() is not None]:
            del self._procs[rid]

    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain every child this launcher still owns (daemon exit)."""
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
