"""One hash-grid snapshot through both students' recipes, in both packages, on the CPU.

``chip_smoke.py`` phases 19-20 build the mesh world's student the way
``Testbed.load_snapshot``'s default does: the snapshot baked on load, then
the baked field distilled and fine-tuned on the capture. The JAX package
built the shipped student from the vertex field instead
(``build_mesh_bench_assets.py:155-161``, ``load_snapshot(..., bake=False)``).
This script takes one snapshot through both recipes in both packages:

- ``snapshot STEPS``: phase 17's capture (the port's rasteriser) and a
  hash-grid field trained STEPS steps on it at phase 18's recipe (4096
  rays x (48 + 16) samples, seed 0) by the JAX package's trainer (the
  port's trains ~10x slower on the CPU); saves ``weights.npz`` (it loads
  in either package) and ``capture.npz`` (the images, poses and crop box
  both packages distill from);
- ``distill PKG TEACHER SEED [SEED ...]``: PKG (``port`` or ``jax``)
  loads the snapshot, its teacher is the ``vertex`` field or the ``baked``
  one, tightens the crop to it, distills (10 octaves) and fine-tunes on the
  capture through its own ``Testbed.distill`` at ``--steps D F`` and each
  seed SEED; saves ``student_PKG_TEACHER_SEED.npz`` and its crop. The port
  runs on ``--device`` (``cpu``, or ``cuda`` on the card); JAX on the CPU;
- ``replay TEACHER SEED``: the port's recipe, as ``distill port``, but fed
  the JAX package's draws of seed SEED (computed here by ``jax.random`` as
  its ``distill`` and ``finetune_photometric`` make them): its cell picks,
  jitter, uniform points and eye directions, its initial student, and each
  fine-tune step's ray indices and sample jitter. Saves
  ``student_replay_TEACHER_SEED.npz``. With the draws equal, what is left
  between it and ``student_jax_TEACHER_SEED`` is the arithmetic; CPU only;
- ``draws SEED``: the random numbers of one whole run at seed SEED, from
  each package (the port's generators as ``distill`` and
  ``finetune_photometric`` draw them, JAX's keys as its functions split
  them), stream by stream: their means, spreads and the two-sample
  Kolmogorov-Smirnov statistic; one JSON line. CPU only;
- ``eval [NAME ...]``: the hold-out PSNR (``chip_smoke.holdout_psnr``: six
  448x448 views, one sample a pixel, 64 + 32 samples a ray) of the named
  students (``student_PKG_TEACHER_SEED``; all in the work folder by
  default), all rendered by the port on ``--device`` (a distilled field
  renders alike in both packages); one JSON line. The teachers' PSNRs come
  from the card (``asset_build_full.py --compare``): a bake and a render of
  the hash field take tens of minutes on the CPU.

Each package draws its own random numbers, so a pair of runs differs by a
seed's worth: the seed spread says how far apart two runs of one package
fall. Run it from the repository's root on the CPU:

    JAX_PLATFORMS=cpu python scripts_dev/student_recipe.py snapshot 1000 --work build/student_recipe
    JAX_PLATFORMS=cpu python scripts_dev/student_recipe.py distill jax vertex 0 --steps 1000 500 --work build/student_recipe
    JAX_PLATFORMS=cpu python scripts_dev/student_recipe.py replay vertex 0 --steps 1000 500 --work build/student_recipe
    JAX_PLATFORMS=cpu python scripts_dev/student_recipe.py draws 0 --steps 1000 500 --work build/student_recipe
    python scripts_dev/student_recipe.py eval --work build/student_recipe

and the port's seeds on the card (the work folder copied there with the
snapshot and the capture): ``distill port vertex 0 1 2 --device cuda`` then
``eval --device cuda``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def snapshot(work: Path, steps: int):
    import jax
    import torch

    import chip_smoke

    jax.config.update("jax_platforms", "cpu")
    from pixtrack_tpu.nerf.dataset import NerfDataset
    from pixtrack_tpu.nerf.snapshot import save_snapshot
    from pixtrack_tpu.nerf.train import TrainConfig, train

    cap = chip_smoke.phase_capture(torch.device("cpu"))
    ds = cap.ds
    np.savez(work / "capture.npz", images=ds.images, c2w=ds.c2w, intrinsics=[ds.fx, ds.fy, ds.cx, ds.cy],
             size=[ds.width, ds.height], aabb=np.asarray(cap.aabb, np.float32))
    jds, aabb = load_capture(work, NerfDataset)
    cfg = TrainConfig(n_steps=steps, batch_rays=4096, n_coarse=48, n_fine=16, log_every=max(steps // 10, 1))
    field, params, info = train(jds, aabb, cfg, seed=0)
    save_snapshot(work / "weights.npz", field, params, extra={"aabb": np.asarray(aabb).tolist()})
    print(json.dumps({"part": "snapshot", "steps": steps, "seconds": info["seconds"],
                      "loss": [[k, v] for k, v in info["history"]]}), flush=True)


def load_capture(work: Path, dataset_cls):
    z = np.load(work / "capture.npz")
    fx, fy, cx, cy = (float(v) for v in z["intrinsics"])
    w, h = (int(v) for v in z["size"])
    return dataset_cls(images=z["images"], c2w=z["c2w"], fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h), z["aabb"]


def distill_port(work: Path, teacher: str, seed: int, steps, device: str = "cpu"):
    import torch

    from pixtrack_tpu_torch.nerf.dataset import NerfDataset
    from pixtrack_tpu_torch.nerf.distill import DistillConfig, save_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed

    torch.set_grad_enabled(True)
    ds, _ = load_capture(work, NerfDataset)
    tb = Testbed(device=device)
    tb.load_snapshot(work / "weights.npz", bake=teacher == "baked")
    tb.tighten_render_bounds()
    tb.distill(config=DistillConfig(steps=steps[0], octaves=10), seed=seed, finetune_dataset=ds,
               finetune_steps=steps[1])
    save_distilled(work / f"student_port_{teacher}_{seed}.npz", tb._baked)
    return tb.render_aabb.min, tb.render_aabb.max, tb._sphere


def distill_jax(work: Path, teacher: str, seed: int, steps):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pixtrack_tpu.nerf.dataset import NerfDataset
    from pixtrack_tpu.nerf.distill import DistillConfig, save_distilled
    from pixtrack_tpu.nerf.testbed import Testbed

    ds, _ = load_capture(work, NerfDataset)
    tb = Testbed()
    tb.load_snapshot(work / "weights.npz", bake=teacher == "baked")
    tb.tighten_render_bounds()
    tb.distill(config=DistillConfig(steps=steps[0], octaves=10), seed=seed, finetune_dataset=ds,
               finetune_steps=steps[1])
    save_distilled(work / f"student_jax_{teacher}_{seed}.npz", tb._baked)
    return tb.render_aabb.min, tb.render_aabb.max, tb._sphere


def jax_draws(seed: int, n_occ: int, cfg, work: Path):
    """The JAX package's draws for ``distill(key=PRNGKey(seed))``: the
    port's ``noise`` dict (cell picks, jitter, uniform points; eye
    directions) and the path of its initial student (saved by JAX), split
    from the key as ``distill`` and ``_sample_points`` split it."""
    import jax

    from pixtrack_tpu.nerf.distill import init_distilled, save_distilled

    N = cfg.dataset_size
    n_sur = int(N * cfg.surface_frac)
    k_data, k_dir, k_init, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    k1, k2, k3 = jax.random.split(k_data, 3)
    points = (np.asarray(jax.random.randint(k1, (n_sur,), 0, n_occ)),
              np.asarray(jax.random.uniform(k2, (3, n_sur))),
              np.asarray(jax.random.uniform(k3, (3, N - n_sur))))
    eye = np.asarray(jax.random.normal(jax.random.split(k_dir)[0], (3, N)))
    init = work / f"init_jax_{seed}.npz"
    save_distilled(init, init_distilled(k_init, octaves=cfg.octaves, width=cfg.width, depth=cfg.depth))
    return {"points": points, "eye": eye}, init


class JaxFinetuneDraws:
    """Stand-ins for the port's ``train.batch_indices`` and
    ``render._draw_noise`` that hand out, step by step, the ray indices and
    sample jitter of the JAX package's ``finetune_photometric(seed=seed)``:
    ``key, k = split(key)``, ``k_idx, k_render = split(k)``, the indices
    ``randint(k_idx)``, the jitter ``uniform(split(k_render)[0])``."""

    def __init__(self, seed: int):
        import jax

        self.jax = jax
        self.key = jax.random.PRNGKey(seed)
        self.k_noise = None

    def batch_indices(self, generator, n_rays: int, batch: int):
        import torch

        random = self.jax.random
        self.key, k = random.split(self.key)
        k_idx, k_render = random.split(k)
        self.k_noise = random.split(k_render)[0]
        return torch.as_tensor(np.asarray(random.randint(k_idx, (batch,), 0, n_rays)), dtype=torch.int64)

    def draw_noise(self, n_rays: int, cfg, generator, device):
        import torch

        noise = self.jax.random.uniform(self.k_noise, (n_rays, cfg.n_coarse))
        return torch.as_tensor(np.asarray(noise), device=device), None


def replay(work: Path, teacher: str, seed: int, steps):
    """The port's recipe of ``distill_port`` on the CPU, every draw the JAX
    package's at ``seed`` (``Testbed.distill``'s steps spelled out, so that
    the draws can be passed in)."""
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from pixtrack_tpu_torch.nerf import render as trender
    from pixtrack_tpu_torch.nerf import train as ttrain
    from pixtrack_tpu_torch.nerf.baked import main_component, occupancy_grid
    from pixtrack_tpu_torch.nerf.dataset import NerfDataset
    from pixtrack_tpu_torch.nerf.distill import (DistillConfig, distill as port_distill, finetune_photometric,
                                                 load_distilled, save_distilled)
    from pixtrack_tpu_torch.nerf.testbed import Testbed

    torch.set_grad_enabled(True)
    ds, _ = load_capture(work, NerfDataset)
    tb = Testbed(device="cpu")
    tb.load_snapshot(work / "weights.npz", bake=teacher == "baked")
    tb.tighten_render_bounds()
    field = tb._render_field()
    occ = occupancy_grid(field)
    mask = main_component(occ)
    occ = occ & mask
    aabb = np.asarray([tb.render_aabb.min, tb.render_aabb.max], np.float32)
    cfg = DistillConfig(steps=steps[0], octaves=10)
    noise, init = jax_draws(seed, int(occ.sum()), cfg, work)
    student = port_distill(field, aabb, occ=occ, config=cfg, seed=seed, density_mask=mask,
                           student=load_distilled(init, device="cpu"), noise=noise)
    draws = JaxFinetuneDraws(seed + 1)
    saved = ttrain.batch_indices, trender._draw_noise
    ttrain.batch_indices, trender._draw_noise = draws.batch_indices, draws.draw_noise
    try:
        student = finetune_photometric(student, ds, aabb, steps=steps[1], seed=seed + 1)
    finally:
        ttrain.batch_indices, trender._draw_noise = saved
    save_distilled(work / f"student_replay_{teacher}_{seed}.npz", student)
    return tb.render_aabb.min, tb.render_aabb.max, tb._sphere


def compare_draws(work: Path, seed: int, steps):
    """Each random stream of one whole run at ``seed``, from both packages:
    mean, standard deviation and the two-sample KS statistic (its p-value
    with it) on up to 2**21 values a stream."""
    import jax
    import torch
    from scipy import stats

    jax.config.update("jax_platforms", "cpu")
    from pixtrack_tpu_torch.nerf.dataset import NerfDataset
    from pixtrack_tpu_torch.nerf.distill import DistillConfig, init_distilled
    from pixtrack_tpu_torch.nerf.render import RenderConfig
    from pixtrack_tpu_torch.nerf.train import ray_pool

    cfg = DistillConfig(steps=steps[0], octaves=10)
    N = cfg.dataset_size
    n_sur = int(N * cfg.surface_frac)
    n_occ = 100_000  # the picks are uniform over the cells whatever their number
    ds, _ = load_capture(work, NerfDataset)
    _, _, rgbs = ray_pool(ds, 1 << 21, "white", seed + 1, "cpu")
    n_rays = rgbs.shape[0]
    batch, n_coarse = 1 << 13, 64

    g = torch.Generator().manual_seed(seed)
    port = {"pick": torch.randint(0, n_occ, (n_sur,), generator=g).numpy() / n_occ,
            "jitter": torch.rand(3, n_sur, generator=g).numpy(),
            "uniform": torch.rand(3, N - n_sur, generator=g).numpy(),
            "eye": torch.randn(3, N, generator=g).numpy(),
            "init": np.concatenate([t.numpy().ravel() for t in init_distilled(seed, octaves=10, device="cpu").tensors()
                                    if t.shape[1] > 1])}
    g = torch.Generator().manual_seed(seed + 1)
    idx, jit = [], []
    for _ in range(steps[1]):
        idx.append(torch.randint(0, n_rays, (batch,), generator=g).numpy())
        jit.append(torch.rand(batch, n_coarse, generator=g).numpy())
    port["ray_index"], port["ray_jitter"] = np.concatenate(idx) / n_rays, np.concatenate(jit)

    noise, init = jax_draws(seed, n_occ, cfg, work)
    with np.load(init) as z:
        jinit = np.concatenate([z[k].ravel() for k in sorted(z.files) if k.endswith("_k")])
    draws = JaxFinetuneDraws(seed + 1)
    idx, jit = [], []
    for _ in range(steps[1]):
        idx.append(draws.batch_indices(None, n_rays, batch).numpy())
        jit.append(draws.draw_noise(batch, RenderConfig(n_coarse=n_coarse), None, "cpu")[0].numpy())
    ref = {"pick": noise["points"][0] / n_occ, "jitter": noise["points"][1], "uniform": noise["points"][2],
           "eye": noise["eye"], "init": jinit, "ray_index": np.concatenate(idx) / n_rays,
           "ray_jitter": np.concatenate(jit)}
    # the share of foreground rays in the fine-tune batches (the pool puts them first)
    n_fg = int(((rgbs - 1.0).abs().amax(dim=1) > 0.02).sum())
    rows = {"foreground_share": {"pool": n_fg / n_rays, "port": float((port["ray_index"] * n_rays < n_fg).mean()),
                                 "jax": float((ref["ray_index"] * n_rays < n_fg).mean())}}
    rng = np.random.default_rng(0)
    for name in port:
        a, b = (np.asarray(v, np.float64).ravel() for v in (port[name], ref[name]))
        a, b = (v if v.size <= 1 << 21 else rng.choice(v, 1 << 21, replace=False) for v in (a, b))
        ks = stats.ks_2samp(a, b)
        rows[name] = {"n": [int(np.size(port[name])), int(np.size(ref[name]))], "mean": [a.mean(), b.mean()],
                      "std": [a.std(), b.std()], "ks": float(ks.statistic), "p": float(ks.pvalue)}
    print(json.dumps({"part": "draws", "seed": seed, "port_then_jax": rows}), flush=True)


def distill(work: Path, pkg: str, teacher: str, seed: int, steps, device: str = "cpu"):
    t0 = time.perf_counter()
    if pkg == "replay":
        lo, hi, sphere = replay(work, teacher, seed, steps)
    elif pkg == "port":
        lo, hi, sphere = distill_port(work, teacher, seed, steps, device)
    else:
        lo, hi, sphere = distill_jax(work, teacher, seed, steps)
    crop = {"aabb": [[float(v) for v in lo], [float(v) for v in hi]],
            "sphere": None if sphere is None else [float(v) for v in np.asarray(sphere)]}
    (work / f"student_{pkg}_{teacher}_{seed}.json").write_text(json.dumps(crop))
    print(json.dumps({"part": "distill", "package": pkg, "teacher": teacher, "seed": seed, "steps": steps,
                      "device": device if pkg == "port" else "cpu", "seconds": time.perf_counter() - t0, **crop}),
          flush=True)


def evaluate(work: Path, names, device: str = "cpu"):
    import torch

    import chip_smoke
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed

    torch.set_grad_enabled(False)
    cap = chip_smoke.phase_capture(torch.device(device))
    rows = {}
    for path in [work / f"{n}.npz" for n in names] or sorted(work.glob("student_*.npz")):
        crop = json.loads(path.with_suffix(".json").read_text())
        tb = Testbed(device=device)
        tb.set_baked_field(load_distilled(path, device=device))
        tb.render_aabb.min, tb.render_aabb.max = crop["aabb"]
        tb._sphere = None if crop["sphere"] is None else np.asarray(crop["sphere"], np.float32)
        rows[path.stem] = chip_smoke.holdout_psnr(tb, cap)
        print(f"{path.stem}: full / object {rows[path.stem]}", flush=True)
    print(json.dumps({"part": "eval", "psnr_full_object_db": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("snapshot", "distill", "replay", "draws", "eval"))
    ap.add_argument("args", nargs="*")
    ap.add_argument("--work", default="build/student_recipe")
    ap.add_argument("--steps", type=int, nargs=2, default=[1000, 500], help="distillation and fine-tune steps")
    ap.add_argument("--device", default="cpu", help="the port's device: cpu, or cuda on the card")
    a = ap.parse_args()
    work = Path(a.work)
    work.mkdir(parents=True, exist_ok=True)
    if a.part == "snapshot":
        snapshot(work, int(a.args[0]) if a.args else 1000)
    elif a.part == "distill":
        pkg, teacher, *seeds = a.args
        assert pkg in ("port", "jax") and teacher in ("vertex", "baked") and seeds
        for seed in seeds:
            distill(work, pkg, teacher, int(seed), a.steps, a.device)
    elif a.part == "replay":
        teacher, seed = a.args
        assert teacher in ("vertex", "baked")
        distill(work, "replay", teacher, int(seed), a.steps)
    elif a.part == "draws":
        compare_draws(work, int(a.args[0]) if a.args else 0, a.steps)
    else:
        evaluate(work, a.args, a.device)


if __name__ == "__main__":
    main()
