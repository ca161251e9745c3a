"""Checkpoint / resume (``oim_tpu/train/checkpoint.py``), torch-native.

The JAX package saves through orbax; this format is NOT interchangeable
with orbax: a checkpoint of one package cannot be restored by the other.
Each step is a directory ``<dir>/<step>/`` holding ``state.pt`` (a
``torch.save`` of step, params, extra and the optimizer's count, mu and
nu, loaded back with ``weights_only=True``). A save writes into a
temporary directory beside the final one, fsyncs the file and both
directories, then renames it into place, so a crash never leaves a half
checkpoint that ``latest_step`` would pick; leftover temporary
directories are ignored. A step at or below the latest one on disk is
not written again (orbax's manager skips it too). Tensors keep their dtype, shape and strides
(conv kernels stay channels_last), so a restored state is the saved one
byte for byte.
"""

from __future__ import annotations

import os
import shutil
import threading

import torch

from oim_tpu_torch.train.state import OptState, TrainState

STATE_FILE = "state.pt"
_TMP = ".tmp-"


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """save(step, state) / latest_step() / restore(step), keeping the
    newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, state: TrainState, wait: bool = False) -> bool:
        """Snapshot ``state`` to host memory now (the step goes on updating
        the live tensors in place), write it in the background; ``wait``
        blocks until it is on disk. One save is in flight at a time.
        Returns False, writing nothing, for a step at or below the latest
        one on disk."""
        self.wait_until_finished()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        copy = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        snap = {
            "step": int(step),
            "params": _map(copy, state.params),
            "extra": _map(copy, state.extra),
            "opt_state": {"count": int(state.opt_state.count),
                          "mu": _map(copy, state.opt_state.mu),
                          "nu": _map(copy, state.opt_state.nu)},
        }
        self._writer = threading.Thread(target=self._write, args=(int(step), snap),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step: int, snap: dict) -> None:
        try:
            final = os.path.join(self.directory, str(step))
            tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(snap, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
            for stale in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(stale)))
        except Exception as err:  # noqa: BLE001 - raised again in the caller's thread
            self._error = err

    def wait_until_finished(self) -> None:
        """Join the save in flight; re-raises its error here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint save into {self.directory} failed") from err

    def all_steps(self) -> list[int]:
        """Completed steps, oldest first (temporary directories skipped)."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device="cpu") -> TrainState:
        """The TrainState saved at ``step`` (default: the latest) on
        ``device``; FileNotFoundError when there is none."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        snap = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location=torch.device(device), weights_only=True)
        opt = snap["opt_state"]
        return TrainState(step=snap["step"], params=snap["params"],
                          opt_state=OptState(count=opt["count"], mu=opt["mu"], nu=opt["nu"]),
                          extra=snap["extra"])

    def close(self) -> None:
        self.wait_until_finished()
