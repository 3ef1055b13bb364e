"""Tracker template: the per-frame refine/relocalize loop.

Port of ``pixtrack_tpu/tracking/base.py`` without its progress bar: refine
each frame, on failure relocalize and retry once, then update the reference
selection.
"""

from __future__ import annotations

from typing import Iterable, Optional


class PoseTracker:
    def refine(self, query) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def relocalize(self, query) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def update_reference_ids(self):  # pragma: no cover - interface
        raise NotImplementedError

    def run_single_frame(self, query) -> bool:
        success = self.refine(query)
        if not success:
            self.relocalize(query)
            success = self.refine(query)
        self.update_reference_ids()
        return success

    def run(self, frames: Iterable, max_frames: Optional[int] = None) -> None:
        for i, query in enumerate(frames):
            if max_frames is not None and i >= max_frames:
                break
            self.run_single_frame(query)
