"""Does the port's ``reconstruct`` land further from the rig than the JAX package's?

``chip_smoke.py`` phase 31 holds the port's ``reconstruct`` over the arc rig to
the JAX package's median over seeds 0-6. This script sets the two packages'
per-seed global rotation medians side by side, as many seeds as each side has:

- JAX: ``scripts_dev/reconstruct_jax.npz`` (``cli`` is seed 0, ``cliN`` seed
  N; ``reconstruct_jax.py cli SEED`` then ``merge`` adds seeds);
- the port: the JSON lines that ``reconstruct_card_seeds.py --cli N`` prints
  (``"run": "cliK"``), read from the files given (the card's or, with
  ``--device cpu``, the CPU's); by default
  ``scripts_dev/reconstruct_port_cpu.jsonl``, the CPU's seeds 0-11 as
  ``reconstruct_card_seeds.py --device cpu --cli 16`` printed them.

It prints each side's seeds, median and spread, the two-sided Mann-Whitney
rank test of the two sets (scipy), and the Hodges-Lehmann shift (the median
of all port - JAX differences), then one JSON line:

    python scripts_dev/reconstruct_rank.py [PORT_LOG ...]

``--replays [FILE]`` reads instead the JSON lines of ``repeat_rule.py replay
SEED`` (both mappers on JAX's draws; by default
``scripts_dev/reconstruct_replay_cpu.jsonl``) and sets the two packages
side by side stage by stage: the chain initialisation's rotation median
against the rig, the model's global rotation median as it enters
featuremetric BA, and the final one. For each stage: each seed's port - JAX
gap on equal draws, the median gap and its magnitude, the Wilcoxon
signed-rank p of the gaps, and the stage's seed spread (the standard
deviation of JAX's values over the seeds); the first stage whose median
gap magnitude exceeds that spread is where the packages part:

    python scripts_dev/reconstruct_rank.py --replays
"""

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
PORT_CPU = REPO / "scripts_dev" / "reconstruct_port_cpu.jsonl"
REPLAYS_CPU = REPO / "scripts_dev" / "reconstruct_replay_cpu.jsonl"
STAGES = (("chain", lambda r, p: r["stages"]["chain_truth_median_deg"][p]),
          ("before featuremetric BA", lambda r, p: r["before_featuremetric_ba"][p]["global_deg"]),
          ("final", lambda r, p: r[p]["global_deg"]))


def jax_seeds() -> dict:
    z = np.load(REPO / "scripts_dev" / "reconstruct_jax.npz")
    out = {}
    for k in z.files:
        if k.startswith("cli") and k.endswith("_global_deg"):
            tag = k[: -len("_global_deg")]
            out[0 if tag == "cli" else int(tag[3:])] = float(z[k])
    return dict(sorted(out.items()))


def port_seeds(paths) -> dict:
    out = {}
    for p in paths:
        for line in Path(p).read_text().splitlines():
            if line.startswith("{") and '"run": "cli' in line:
                row = json.loads(line)
                out[int(row["run"][3:])] = float(row["global_deg"])
    return dict(sorted(out.items()))


def replays(path: Path) -> dict:
    """Stage by stage, the two mappers on equal draws (``repeat_rule.py
    replay`` lines in ``path``); prints a line a stage and returns them."""
    from scipy.stats import wilcoxon

    rows = sorted((json.loads(line) for line in path.read_text().splitlines() if line.startswith("{")),
                  key=lambda r: r["seed"])
    out = {"seeds": [r["seed"] for r in rows], "ka_max_px": [r["stages"]["ka_max_px"] for r in rows], "stages": {}}
    parted = None
    for name, get in STAGES:
        j = np.asarray([get(r, "jax") for r in rows])
        t = np.asarray([get(r, "port") for r in rows])
        gap = t - j
        spread = float(j.std(ddof=1))
        med, med_abs = float(np.median(gap)), float(np.median(np.abs(gap)))
        p = float(wilcoxon(gap).pvalue)
        out["stages"][name] = {"jax": j.tolist(), "port": t.tolist(), "median_gap": med, "median_abs_gap": med_abs,
                               "wilcoxon_p": p, "jax_seed_std": spread}
        if parted is None and med_abs > spread:
            parted = name
        print(f"{name}: JAX {[round(float(x), 3) for x in j]}, the port {[round(float(x), 3) for x in t]} deg; "
              f"port - JAX median {med:+.3f} (magnitude {med_abs:.3f}), Wilcoxon p {p:.3f}; JAX's spread over the "
              f"seeds (std) {spread:.3f}")
    out["parted_at"] = parted
    print(f"KA's keypoints apart by at most {[round(x, 2) for x in out['ka_max_px']]} px; the first stage whose "
          f"median gap exceeds its seed spread: {parted}")
    print(json.dumps(out))
    return out


def main():
    from scipy.stats import mannwhitneyu

    if sys.argv[1:2] == ["--replays"]:
        replays(Path(sys.argv[2]) if len(sys.argv) > 2 else REPLAYS_CPU)
        return
    jax, port = jax_seeds(), port_seeds(sys.argv[1:] or [PORT_CPU])
    a, b = np.asarray(list(port.values())), np.asarray(list(jax.values()))
    test = mannwhitneyu(a, b, alternative="two-sided")
    shift = float(np.median(a[:, None] - b[None, :]))
    for name, d in (("port", port), ("JAX", jax)):
        v = np.asarray(list(d.values()))
        print(f"{name}: seeds {list(d)}, global rotation medians {[round(float(x), 3) for x in v]}; median "
              f"{np.median(v):.3f} deg, range {v.min():.3f}-{v.max():.3f}")
    print(f"two-sided Mann-Whitney: U {test.statistic:.1f}, p {test.pvalue:.4f}; Hodges-Lehmann shift "
          f"(port - JAX) {shift:+.3f} deg")
    print(json.dumps({"port": port, "jax": jax, "port_median": float(np.median(a)), "jax_median": float(np.median(b)),
                      "u": float(test.statistic), "p": float(test.pvalue), "shift_deg": shift}))


if __name__ == "__main__":
    main()
