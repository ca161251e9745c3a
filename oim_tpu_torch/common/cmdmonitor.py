"""Child-process death monitor (reference pkg/oim-common/cmdmonitor.go).

The reference passes an inherited pipe write-end to the child; the parent
detects unexpected termination when the read end hits EOF, without calling
Wait() and racing other waiters (cmdmonitor.go:14-51). Same trick here: the
write fd is kept open in the child via ``pass_fds``; a daemon thread blocks on
the read end and fires a callback/event on EOF.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Callable


class CmdMonitor:
    """Watch a subprocess for unexpected death via an inherited pipe."""

    def __init__(self) -> None:
        self._read_fd, self._write_fd = os.pipe()
        os.set_inheritable(self._write_fd, True)
        self.died = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def child_fd(self) -> int:
        """Pass this in Popen(pass_fds=[monitor.child_fd])."""
        return self._write_fd

    def watch(self, on_death: Callable[[], None] | None = None) -> None:
        """Start watching; call after Popen so the parent's write end can be
        closed (leaving the child's copy as the only holder)."""
        os.close(self._write_fd)

        def _wait() -> None:
            try:
                while os.read(self._read_fd, 4096):
                    pass
            except OSError:
                pass
            finally:
                try:
                    os.close(self._read_fd)
                except OSError:
                    pass
            self.died.set()
            if on_death is not None:
                on_death()

        self._thread = threading.Thread(target=_wait, daemon=True)
        self._thread.start()


def monitored_popen(
    args, on_death: Callable[[], None] | None = None, **kwargs
) -> tuple[subprocess.Popen, CmdMonitor]:
    """Spawn a subprocess with a death monitor attached."""
    monitor = CmdMonitor()
    pass_fds = tuple(kwargs.pop("pass_fds", ())) + (monitor.child_fd,)
    proc = subprocess.Popen(args, pass_fds=pass_fds, close_fds=True, **kwargs)
    monitor.watch(on_death)
    return proc, monitor
