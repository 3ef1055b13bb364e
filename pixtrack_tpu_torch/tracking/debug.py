"""DebugTracker: the optimizer observer.

Port of ``pixtrack_tpu/tracking/debug.py``. Attach to a Refiner to record,
per refinement call:
- debug >= 1: per-iteration masked costs, step magnitudes (dt, dR), accept
  flags (``log_optim_iter``), and the final pose/points (``log_optim_done``);
- debug >= 2: additionally the dense query feature/confidence maps
  (``log_dense``), the only call that copies a map to the host.

The LM returns the whole per-iteration trace of a level as tensors
(``align_level_traced``); they are copied to numpy once per level. Dumped to
``trackers.pkl`` via ``PixTrackTracker.save_poses``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor or an array as a numpy array on the host."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class DebugTracker:
    def __init__(self, debug: int = 1):
        self.debug = int(debug)
        self.frames: List[dict] = []
        self._current: Optional[dict] = None

    # -- callbacks (Refiner calls these) --------------------------------------
    def start_frame(self, name: str) -> None:
        self._current = {"frame": name, "levels": [], "dense": []}
        self.frames.append(self._current)

    def log_dense(self, level: int, fmap, conf=None) -> None:
        if self.debug < 2 or self._current is None:
            return
        self._current["dense"].append(
            {
                "level": level,
                "fmap": _np(fmap),
                "conf": None if conf is None else _np(conf),
            }
        )

    def log_optim_iter(self, level: int, trace: dict) -> None:
        """trace: arrays of shape (num_iters,) from align_level_traced."""
        if self.debug < 1 or self._current is None:
            return
        active = _np(trace["active"])
        n = int(active.sum())
        self._current["levels"].append(
            {
                "level": level,
                "num_iters": n,
                "costs": _np(trace["cost"])[:n],
                "dt": _np(trace["dt"])[:n],
                "dR": _np(trace["dR"])[:n],
                "accepted": _np(trace["accepted"])[:n],
            }
        )

    def log_optim_done(self, T_refined, p3d=None, cost=None) -> None:
        if self.debug < 1 or self._current is None:
            return
        self._current["T_refined"] = _np(T_refined.to_4x4())
        if cost is not None:
            self._current["cost"] = float(cost)
        if self.debug >= 2 and p3d is not None:
            self._current["p3d"] = _np(p3d)
