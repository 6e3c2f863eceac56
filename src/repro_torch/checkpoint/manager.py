"""Checkpoint lifecycle: rotation, latest-valid discovery, resume.

The counterpart of the reference package's ``checkpoint/manager.py``.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.checkpoint import (
    AsyncWriter,
    CheckpointCorruption,
    load,
    save,
)

_STEP_RE = re.compile(r"step_(\d+)\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.directory = directory
        self.keep = keep
        self.writer = AsyncWriter() if use_async else None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.ckpt")

    def all_steps(self) -> List[int]:
        steps = []
        for p in glob.glob(os.path.join(self.directory, "step_*.ckpt")):
            m = _STEP_RE.search(p)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        meta = dict(metadata or {})
        meta["step"] = step
        path = self._path(step)
        if self.writer:
            self.writer.save(path, tree, meta)
            # the background write may land before or after the rotation:
            # leave its step out, so the same files go either way
            self._rotate(writing=step)
        else:
            save(path, tree, meta)
            self._rotate()

    def wait(self):
        if self.writer:
            self.writer.wait()

    def _rotate(self, writing: Optional[int] = None):
        """Remove all but the ``keep`` newest steps on disk, ``writing``
        (a step whose write is in flight) not counted."""
        steps = [s for s in self.all_steps() if s != writing]
        for s in steps[: -self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def restore_latest(self, like: Any = None
                       ) -> Optional[Tuple[Any, Dict]]:
        """Restore the newest checkpoint that passes validation; corrupt
        ones are skipped (a crash mid-write, a disk fault)."""
        self.wait()
        for step in reversed(self.all_steps()):
            try:
                return load(self._path(step), like=like)
            except (CheckpointCorruption, OSError, ValueError):
                continue
        return None
