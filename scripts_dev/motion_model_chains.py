"""The fused frame with the constant-velocity motion model, chained over the
mesh world's orbit, through the JAX package and the port on the CPU
(``tests/test_torch_motion_model.py::motion_chains``): one JSON line per
frame with both rotation errors against the ground truth, the gap between
the two chains, their costs and success flags.

    JAX_PLATFORMS=cpu python scripts_dev/motion_model_chains.py [N_FRAMES] [STEP_RAD] [WIDTH HEIGHT]
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from test_torch_motion_model import _rot_deg, motion_chains  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    step = float(sys.argv[2]) if len(sys.argv) > 2 else 0.02
    size = (int(sys.argv[3]), int(sys.argv[4])) if len(sys.argv) > 4 else (640, 480)
    for k, jout, tout, T in motion_chains(n, step, size=size, n_coarse=96, num_iters=150):
        print(json.dumps({
            "frame": k, "jax_rot_err_deg": _rot_deg(jout.R, T.R.numpy()),
            "port_rot_err_deg": _rot_deg(tout.R.numpy(), T.R.numpy()), "gap_deg": _rot_deg(jout.R, tout.R.numpy()),
            "jax_cost": float(jout.cost), "port_cost": float(tout.cost), "jax_ok": bool(jout.ok),
            "port_ok": bool(tout.ok),
        }), flush=True)


if __name__ == "__main__":
    main()
