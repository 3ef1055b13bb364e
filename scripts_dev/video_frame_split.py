"""Where the batched video tracker parts from the JAX package, one frame at a time.

``chip_smoke.py`` phase 41 holds the port's ``parallel/video.py`` to the JAX
package's run of the same eight videos of the mesh world
(``scripts_dev/video_batch_jax.npz``). This script takes JAX's stored poses
of frame F - 1 (all eight videos) and refines frame F from them in both
packages, on the CPU, with phase 41's settings (``AlignConfig(num_iters=30)``,
96 coarse samples and no fine pass, the shipped UNet in bf16). ``all``:

- same start: each video's pose and cost gap between the two packages at
  frame F, and JAX's own step against its stored run (it must reproduce it
  to the bit);
- cross: each package's fine-level cost at the other's final pose, on its
  own inputs;
- the inputs: each one's largest gap between the packages, the reference
  renders in detail (``render_gaps``);
- swaps: the port's frame F with JAX's value of one input in place of its
  own (the reference render, the masked query, the query's and the
  reference's UNet pyramids, the per-point observations, the point
  subsample; the render's alpha-cut pixels alone and the render without
  them; the LM's whole input): which swap moves the port to JAX's minimum
  (pose within 0.25 deg, cost within 2e-3 relative);
- the basin: one video's frame F from JAX's previous pose moved by
  k * 1e-6 along x, k = 0-7, as one batch in the port (``--video``), with
  its own render and with JAX's;
- with ``--trace V``: video V's LM level by level and iteration by
  iteration (cost, lambda, accepted, done) in both packages.

The other parts:

- ``jaxbasin``: the basin in JAX's own jitted step;
- ``render``: ``render_gaps`` alone, from the cache;
- ``unet``: the bf16 UNet on the cached images, by the parity test's
  measures (``run_unet``);
- ``spread``: the port's videos 2 and 3 (``--videos``) over the first N
  frames, each from starts moved by k * 1e-6 along x (k = 0..3,
  ``--starts``; phase 7's perturbation) as one batch of 8: each video's
  rotation median at each start, written to
  ``scripts_dev/video_split_port.json``, then ``judge``;
- ``judge``: the port's medians from that file beside JAX's at every start
  the npz holds (k = 0 and each ``video_batch_jax.py 20 k``): the port's
  k = 0 gap to JAX's k = 0 against the larger of JAX's spread over its
  starts and the port's over k >= 1 (the start judged left out of its own
  spread), and the two sets' medians against the larger of the whole
  spreads.

Both packages run here, on the CPU (JAX on a virtual 8-device mesh, as
``video_batch_jax.py`` ran it):

    JAX_PLATFORMS=cpu python scripts_dev/video_frame_split.py all [F] [--trace V] [--video V] [--cache FILE.npz]
    JAX_PLATFORMS=cpu python scripts_dev/video_frame_split.py jaxbasin [F] [--video V]
    JAX_PLATFORMS=cpu python scripts_dev/video_frame_split.py render|unet [F] --cache FILE.npz
    JAX_PLATFORMS=cpu python scripts_dev/video_frame_split.py spread [N_FRAMES] [--videos 2 3] [--starts 4]
    python3 scripts_dev/video_frame_split.py spread 20 --videos 0 1 2 3 4 5 6 7 --device cuda --out OUT.json
    python scripts_dev/video_frame_split.py judge [--out OUT.json]

``--cache`` keeps JAX's frame F and its inputs: the first run writes it,
later runs read it and skip JAX's step. Each part prints one line per
measurement and a JSON line at the end. On 8 shared cores, ``all`` took
~2 h (each port step at B = 8 several minutes), ``spread`` over 20 frames
about as long.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts_dev"))
sys.path.insert(0, str(REPO / "tests"))

B, ITERS = 8, 30
POSE_DEG, COST_REL = 0.25, 2e-3
SWAPS = ("ref_img", "query", "query_pyramid", "ref_pyramid", "observations", "points")


def _so3(R) -> np.ndarray:
    """The rotation nearest to R (f64): the trackers' f32 poses drift from
    orthonormality by ~1e-5 over a few frames, which arccos((tr - 1) / 2)
    alone reads as ~0.25 deg between a pose and itself."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    return U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt


def rot_deg(Ra, Rb) -> float:
    M = _so3(Ra) @ _so3(Rb).T
    return float(np.rad2deg(np.arctan2(np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]),
                                       np.trace(M) - 1)))


def save_flat(path, d: dict):
    """np.savez of a dict whose values may be lists of arrays (``name.i``)."""
    flat = {}
    for k, v in d.items():
        if isinstance(v, (list, tuple)):
            flat.update({f"{k}.{i}": np.asarray(x) for i, x in enumerate(v)})
        else:
            flat[k] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_flat(path) -> dict:
    out, lists = {}, {}
    with np.load(path) as z:
        for k in z.files:
            name, _, i = k.rpartition(".")
            if name and i.isdigit():
                lists.setdefault(name, {})[int(i)] = z[k]
            else:
                out[k] = z[k]
    out.update({k: [v[i] for i in sorted(v)] for k, v in lists.items()})
    return out


def jax_frame(frame: int):
    """JAX's make_production_video_tracker at B = 8 on frame ``frame`` from
    the npz's poses of frame - 1: the real jitted step, and a copy of its body
    that also returns its inputs. Returns (world, {name: numpy})."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    from stepwise_mesh_jax import jax_world

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pixtrack_tpu.align.lm import AlignConfig, align_pyramid
    from pixtrack_tpu.align.observations import build_level_data, observe_points
    from pixtrack_tpu.geometry.nerf_transform import C_CAM, P_W
    from pixtrack_tpu.geometry.pose import Pose
    from pixtrack_tpu.nerf.render import RenderConfig, rays_from_camera, render_rays
    from pixtrack_tpu.parallel.mesh import make_mesh
    from pixtrack_tpu.parallel.video import make_production_video_tracker
    from pixtrack_tpu.tracking.mask import splat_object_mask

    tracker, frames, _, _, _ = jax_world(frame + 1, "bf16")
    testbed = tracker.testbed
    testbed.n_coarse, testbed.n_fine = 96, 0
    mesh = make_mesh(8, tp=1)
    cfg = AlignConfig(num_iters=ITERS)
    run = make_production_video_tracker(mesh, testbed, tracker.nerf2sfm, tracker.refiner.extractor, tracker.scene,
                                        tracker.camera, reference_scale=0.5, align_cfg=cfg)
    ref = np.load(REPO / "scripts_dev" / "video_batch_jax.npz")
    R_prev, t_prev = ref["R"][frame - 1], ref["t"][frame - 1]
    query = np.asarray(frames[frame][1], np.float32) / 255.0
    queries = np.broadcast_to(query[None], (B, *query.shape))
    R1, t1, c1, i1 = (np.asarray(v) for v in run(jnp.asarray(R_prev), jnp.asarray(t_prev), jnp.asarray(queries)))

    # the step's body (parallel/video.py:make_sharded_video_tracker), its inputs kept
    field, params = testbed._baked, None
    aabb = jnp.asarray([testbed.render_aabb.min, testbed.render_aabb.max], jnp.float32)
    xyz = np.asarray(tracker.scene.xyz, np.float32)
    if len(xyz) > 4096:
        xyz = xyz[np.random.default_rng(0).choice(len(xyz), 4096, replace=False)]
    p3d, pmask = jnp.asarray(xyz), jnp.ones(min(len(xyz), 4096), bool)
    camera = tracker.camera
    ref_camera = tracker.scene.camera(tracker.scene.images[int(tracker.scene.image_ids[0])].camera_id).scale(0.5)
    H, W = int(float(camera.height)), int(float(camera.width))
    rH, rW = int(float(ref_camera.height)), int(float(ref_camera.width))
    rf, rc = [float(v) for v in ref_camera.f], [float(v) for v in ref_camera.c]
    PW, CCAM = jnp.asarray(P_W, jnp.float32), jnp.asarray(C_CAM, jnp.float32)
    n2s = tracker.nerf2sfm
    R3, centroid = jnp.asarray(n2s.R3, jnp.float32), jnp.asarray(n2s.centroid, jnp.float32)
    totp, scale = jnp.asarray(n2s.totp, jnp.float32), jnp.float32(n2s.scale)
    extractor = tracker.refiner.extractor.traced
    rcfg = RenderConfig(n_coarse=96, n_fine=0, perturb=False)

    def rays_of(T):
        Tinv = T.inv()
        t = R3 @ ((PW @ Tinv.t - centroid) * scale) - totp
        c2w = jnp.concatenate([R3 @ (PW @ Tinv.R @ CCAM), t[:, None]], axis=1)
        c2w = jnp.concatenate([c2w, jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0)
        return rays_from_camera(c2w, rf[0], rf[1], rc[0], rc[1], rW, rH)

    def per_frame(T, ref_img, query):
        q = query * splat_object_mask(T, camera, p3d, (H, W))[..., None]
        ref_pyr = extractor(ref_img)
        f_ref, w_ref, v_ref = observe_points(ref_pyr, T, ref_camera, p3d, pmask)
        pyr = extractor(q)
        levels = build_level_data(pyr, f_ref, w_ref, v_ref, p3d, pmask)
        final, states = align_pyramid(T, levels, camera, cfg)
        return (final.T.R, final.T.t, final.cost, sum(s.num_iters for s in states), q,
                ref_pyr.levels, ref_pyr.confidences, pyr.levels, pyr.confidences, f_ref, w_ref, v_ref,
                tuple(s.T.R for s in states), tuple(s.T.t for s in states), tuple(s.cost for s in states),
                tuple(s.num_iters for s in states))

    dp = lambda x: NamedSharding(mesh, P("dp", *([None] * (max(x.ndim, 1) - 1))))  # noqa: E731

    @jax.jit
    def body(R, t, queries):
        R, t = jax.lax.with_sharding_constraint(R, dp(R)), jax.lax.with_sharding_constraint(t, dp(t))
        queries = jax.lax.with_sharding_constraint(queries, dp(queries))
        T = Pose.from_Rt(R, t)
        origins, dirs = jax.vmap(rays_of)(T)
        out = render_rays(field, params, origins.reshape(B * rH * rW, 3), dirs.reshape(B * rH * rW, 3), aabb, rcfg)
        rgb = out["rgb"] + (1.0 - out["alpha"][:, None]) * 1.0
        rgb = jnp.where(out["alpha"][:, None] > 1e-2, rgb, 0.0)
        ref_imgs = rgb.reshape(B, rH, rW, 3)
        return (ref_imgs, out["alpha"].reshape(B, rH, rW)) + jax.vmap(per_frame)(T, ref_imgs, queries)

    o = jax.tree.map(np.asarray, body(jnp.asarray(R_prev), jnp.asarray(t_prev), jnp.asarray(queries)))
    names = ("ref_img", "ref_alpha", "R", "t", "cost", "iters", "query", "ref_levels", "ref_confs", "q_levels", "q_confs",
             "f_ref", "w_ref", "v_ref", "lvl_R", "lvl_t", "lvl_cost", "lvl_iters")
    out = dict(zip(names, o))
    out.update(run_R=R1, run_t=t1, run_cost=c1, run_iters=i1, R_prev=R_prev, t_prev=t_prev, p3d=xyz,
               stored_R=ref["R"][frame], stored_cost=ref["cost"][frame])
    out = {k: [np.asarray(x, np.float32) if x.dtype.name == "bfloat16" else x for x in v]
           if isinstance(v, (list, tuple)) else v for k, v in out.items()}
    return jax_world_of(frame, tracker), out


def jax_world_of(frame: int, tracker=None) -> dict:
    """What the cost evaluations and the LM trace need of JAX's world."""
    from pixtrack_tpu.align.lm import AlignConfig

    if tracker is None:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8").strip()
        from stepwise_mesh_jax import jax_world

        tracker = jax_world(frame + 1, "bf16")[0]
    return dict(tracker=tracker, camera=tracker.camera, cfg=AlignConfig(num_iters=ITERS))


def jax_cost_at(world, jo, R, t, level: int = 0):
    """JAX's cost (residual_cost) of each video at poses (B,) on its own level data."""
    import jax
    import jax.numpy as jnp

    from pixtrack_tpu.align.lm import LevelData, residual_cost
    from pixtrack_tpu.geometry.pose import Pose

    tr = world["tracker"]
    extr = tr.refiner.extractor
    out = []
    for b in range(B):
        sx = sy = 1.0 / extr.scales[level]  # no resize at 640 x 480: the level's scale is 1 / its stride
        data = LevelData(p3d=jnp.asarray(jo["p3d"]), f_ref=jnp.asarray(jo["f_ref"][level][b]),
                         w_ref=jnp.asarray(jo["w_ref"][level][b]),
                         mask=jnp.asarray(jo["v_ref"][level][b]), fmap=jnp.asarray(jo["q_levels"][level][b]),
                         conf=jnp.asarray(jo["q_confs"][level][b]), scale=jnp.asarray([sx, sy], jnp.float32))
        c, _ = jax.jit(residual_cost, static_argnums=(3,))(Pose.from_Rt(jnp.asarray(R[b]), jnp.asarray(t[b])), data,
                                                           world["camera"], world["cfg"])
        out.append(float(c))
    return np.asarray(out)


class PortFrame:
    """The port's VideoStep of phase 41 on the CPU, with each input of its
    frame replaceable."""

    def __init__(self, frame: int):
        import torch

        import chip_smoke
        from pixtrack_tpu_torch.align.lm import AlignConfig
        from pixtrack_tpu_torch.parallel import make_production_video_tracker

        torch.set_grad_enabled(False)
        self.assets = chip_smoke.mesh_assets(torch.device("cpu"), frame + 1)
        tb = self.assets.testbed
        tb.n_coarse, tb.n_fine = 96, 0
        self.run = make_production_video_tracker(tb, self.assets.n2s, self.assets.extractor, self.assets.scene,
                                                 self.assets.camera, reference_scale=0.5,
                                                 align_cfg=AlignConfig(num_iters=ITERS))
        self.query = torch.as_tensor(self.assets.frames[frame][1]).float() / 255.0

    def step(self, R, t, swap=None):
        """The step's body (parallel/video.py VideoStep.__call__) at poses (B,)
        with ``swap`` {input: numpy} in place of the port's own; returns a
        dict of its inputs and outputs as numpy."""
        import torch

        from pixtrack_tpu_torch.align.lm import align_pyramid
        from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
        from pixtrack_tpu_torch.features.pyramid import FeaturePyramid
        from pixtrack_tpu_torch.geometry import Pose
        from pixtrack_tpu_torch.tracking.mask import splat_object_mask

        swap = swap or {}
        run = self.run
        tt = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
        T = Pose(tt(R).float(), tt(t).float())
        p3d = tt(swap["points"]) if "points" in swap else run.p3d
        pmask = torch.ones(p3d.shape[0], dtype=torch.bool)
        ref_img, ref_alpha = self.render(T)
        if "ref_img" in swap:
            ref_img = tt(swap["ref_img"])
        queries = self.query[None].expand(B, *self.query.shape)
        q = tt(swap["query"]) if "query" in swap else \
            queries * splat_object_mask(T, run.camera, p3d, (run.H, run.W))[..., None]
        ref_pyr = run.extractor(ref_img)
        if "ref_pyramid" in swap:
            lv, cf = swap["ref_pyramid"]
            ref_pyr = FeaturePyramid(tuple(tt(x).to(ref_pyr.levels[0].dtype) for x in lv), ref_pyr.scales,
                                     tuple(tt(x).to(ref_pyr.confidences[0].dtype) for x in cf))
        pyr = run.extractor(q)
        if "query_pyramid" in swap:
            lv, cf = swap["query_pyramid"]
            pyr = FeaturePyramid(tuple(tt(x).to(pyr.levels[0].dtype) for x in lv), pyr.scales,
                                 tuple(tt(x).to(pyr.confidences[0].dtype) for x in cf))
        f_ref, w_ref, v_ref = observe_points(ref_pyr, T, run.ref_camera, p3d, pmask)
        if "observations" in swap:
            f_ref, w_ref, v_ref = (tuple(tt(x) for x in part) for part in swap["observations"])
        levels = build_level_data(pyr, f_ref, w_ref, v_ref, p3d, pmask)
        final, states = align_pyramid(T, levels, run.camera, run.align_cfg)
        n = lambda x: x.float().numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
        return {"R": n(final.T.R), "t": n(final.T.t), "cost": n(final.cost),
                "iters": n(sum(s.num_iters for s in states)), "ref_img": n(ref_img), "ref_alpha": n(ref_alpha), "query": n(q),
                "ref_levels": [n(x) for x in ref_pyr.levels], "ref_confs": [n(x) for x in ref_pyr.confidences],
                "q_levels": [n(x) for x in pyr.levels], "q_confs": [n(x) for x in pyr.confidences],
                "f_ref": [n(x) for x in f_ref], "w_ref": [n(x) for x in w_ref], "v_ref": [n(x) for x in v_ref],
                "lvl_R": [n(s.T.R) for s in states], "lvl_t": [n(s.T.t) for s in states],
                "lvl_cost": [n(s.cost) for s in states], "lvl_iters": [n(s.num_iters) for s in states],
                "levels": levels, "T": T}

    def render(self, T):
        """The step's reference renders at poses T (B,) and their alpha."""
        from pixtrack_tpu_torch.parallel import video

        alpha = []
        render = video.render_rays
        video.render_rays = lambda *a, **k: (lambda o: alpha.append(o["alpha"]) or o)(render(*a, **k))
        try:
            ref_img = self.run.render_references(T)
        finally:
            video.render_rays = render
        return ref_img, alpha[0].reshape(-1, self.run.rH, self.run.rW)

    def cost_at(self, out, R, t, level: int = 0):
        from pixtrack_tpu_torch.align.lm import residual_cost
        from pixtrack_tpu_torch.geometry import Pose

        import torch

        T = Pose(torch.as_tensor(np.asarray(R)).float(), torch.as_tensor(np.asarray(t)).float())
        c, _ = residual_cost(T, out["levels"][level], self.run.camera, self.run.align_cfg)
        return c.numpy()


def gaps(po, jo):
    """Per video: the port's pose gap to JAX's (deg) and its cost gap (relative)."""
    rot = [rot_deg(po["R"][b], jo["R"][b]) for b in range(B)]
    cost = np.abs(po["cost"] - jo["cost"]) / jo["cost"]
    return np.asarray(rot), cost


def lands(po, jo):
    rot, cost = gaps(po, jo)
    return (rot <= POSE_DEG) & (cost <= COST_REL)


def input_gaps(po, jo) -> dict:
    """The largest gap of each input between the packages (and, for the UNet
    pyramids, the bf16 parity test's measures: mean and share equal)."""
    out = {"ref_img": float(np.abs(po["ref_img"] - jo["ref_img"]).max()),
           "query": float(np.abs(po["query"] - jo["query"]).max()),
           "points": 0.0}
    for name, pl, pc, jl, jc in (("ref_pyramid", "ref_levels", "ref_confs", "ref_levels", "ref_confs"),
                                 ("query_pyramid", "q_levels", "q_confs", "q_levels", "q_confs")):
        d = [np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
             for a, b in zip(list(po[pl]) + list(po[pc]), list(jo[jl]) + list(jo[jc]))]
        out[name] = float(max(x.max() for x in d))
        out[name + "_mean"] = float(np.mean(np.concatenate([x.ravel() for x in d])))
        out[name + "_equal"] = float(np.mean(np.concatenate([(x == 0).ravel() for x in d])))
    out["observations"] = float(max(np.abs(a - b).max() for a, b in zip(po["f_ref"], jo["f_ref"])))
    out["observation_weights"] = float(max(np.abs(a - b).max() for a, b in zip(po["w_ref"], jo["w_ref"])))
    out["observation_valid_differ"] = int(sum((a != b).sum() for a, b in zip(po["v_ref"], jo["v_ref"])))
    return out


def silhouette_flips(po, jo) -> np.ndarray:
    """(B, rH, rW): pixels black (alpha <= 1e-2, the production render's
    cut) in one package's reference render and not in the other's."""
    return (po["ref_alpha"] > 1e-2) != (jo["ref_alpha"] > 1e-2)


def render_gaps(po, jo) -> dict:
    """The reference renders against each other: the pixels the alpha cut
    flips, the alpha there, and every other pixel against the trained-field
    render rule of tests/test_torch_nerf.py (5e-3 on 99.9 %, 1e-2 on all)."""
    flip = silhouette_flips(po, jo)
    da = np.abs(po["ref_alpha"] - jo["ref_alpha"])
    drgb = np.abs(po["ref_img"] - jo["ref_img"]).max(-1)
    rest = drgb[~flip]
    return {"rays": int(da.size), "alpha_beyond_5e-3": int((da > 5e-3).sum()), "alpha_beyond_1e-2": int((da > 1e-2).sum()),
            "rgb_elsewhere_beyond_5e-3": int((rest > 5e-3).sum()), "rgb_elsewhere_beyond_1e-2": int((rest > 1e-2).sum()),
            "flips_per_video": flip.reshape(B, -1).sum(1).tolist(),
            "alpha_at_flips": [float(x) for x in np.concatenate([po["ref_alpha"][flip], jo["ref_alpha"][flip]])],
            "alpha_gap_at_flips_max": float(da[flip].max()) if flip.any() else 0.0,
            "alpha_gap_max": float(da.max()), "alpha_gap_q999": float(np.quantile(da, 0.999)),
            "rgb_gap_elsewhere_max": float(rest.max()), "rgb_gap_elsewhere_q999": float(np.quantile(rest, 0.999)),
            "within_render_rule": bool(np.quantile(da, 0.999) <= 5e-3 and da.max() <= 1e-2
                                       and np.quantile(rest, 0.999) <= 5e-3 and rest.max() <= 1e-2)}


def basin(pf, jo, video: int, ref_img=None) -> dict:
    """Video ``video``'s frame from JAX's previous pose moved by k * 1e-6
    along x, k = 0..B-1, as one batch in the port (each problem alone, as
    the batched LM keeps them): where each start lands against JAX's pose.
    ``ref_img`` (rH, rW, 3) in place of the port's renders."""
    R = np.repeat(jo["R_prev"][video][None], B, 0)
    t = np.repeat(jo["t_prev"][video][None], B, 0)
    t[:, 0] += np.arange(B, dtype=np.float32) * np.float32(1e-6)
    so = pf.step(R, t, None if ref_img is None else {"ref_img": np.repeat(ref_img[None], B, 0)})
    rot = [rot_deg(so["R"][k], jo["R"][video]) for k in range(B)]
    cost = (np.abs(so["cost"] - jo["cost"][video]) / jo["cost"][video]).tolist()
    return {"rot_deg": rot, "cost_rel": cost, "cost": so["cost"].tolist(),
            "lands": [bool(r <= POSE_DEG and c <= COST_REL) for r, c in zip(rot, cost)]}


def run_all(frame: int, trace, cache, video: int):
    t_start = time.perf_counter()
    if cache and Path(cache).exists():
        jo, world = load_flat(cache), jax_world_of(frame)
        print(f"JAX's frame {frame} read from {cache}", flush=True)
    else:
        world, jo = jax_frame(frame)
        if cache:
            save_flat(cache, jo)
    rep = {"frame": frame,
           "jax_body_vs_run_deg": max(rot_deg(jo["R"][b], jo["run_R"][b]) for b in range(B)),
           "jax_body_vs_run_cost": float(np.abs(jo["cost"] - jo["run_cost"]).max()),
           "jax_run_vs_stored_deg": max(rot_deg(jo["run_R"][b], jo["stored_R"][b]) for b in range(B)),
           "jax_run_vs_stored_cost": float(np.abs(jo["run_cost"] - jo["stored_cost"]).max())}
    print(f"JAX frame {frame}: the body's copy against the jitted step {rep['jax_body_vs_run_deg']:.2e} deg, "
          f"cost {rep['jax_body_vs_run_cost']:.2e}; the step against the stored run "
          f"{rep['jax_run_vs_stored_deg']:.2e} deg, cost {rep['jax_run_vs_stored_cost']:.2e}", flush=True)
    pf = PortFrame(frame)
    po = pf.step(jo["R_prev"], jo["t_prev"])
    rot, cost = gaps(po, jo)
    rep["same"] = {"rot_deg": rot.tolist(), "cost_rel": cost.tolist(), "port_cost": po["cost"].tolist(),
                   "jax_cost": jo["cost"].tolist(), "port_iters": po["iters"].tolist(),
                   "jax_iters": jo["iters"].tolist()}
    for b in range(B):
        print(f"same start, video {b}: port cost {po['cost'][b]:.6f} ({int(po['iters'][b])} it), JAX "
              f"{jo['cost'][b]:.6f} ({int(jo['iters'][b])} it); pose gap {rot[b]:.3f} deg, cost gap {cost[b]:.2e}; "
              f"per level (coarse -> fine) port {[round(float(c[b]), 6) for c in po['lvl_cost']]} JAX "
              f"{[round(float(c[b]), 6) for c in jo['lvl_cost']]}", flush=True)
    # cross-evaluation at the fine level
    c_port_at_jax = pf.cost_at(po, jo["R"], jo["t"])
    c_jax_at_port = jax_cost_at(world, jo, po["R"], po["t"])
    c_port_own = pf.cost_at(po, po["R"], po["t"])
    c_jax_own = jax_cost_at(world, jo, jo["R"], jo["t"])
    rep["cross"] = {"port_at_port": c_port_own.tolist(), "port_at_jax": c_port_at_jax.tolist(),
                    "jax_at_jax": c_jax_own.tolist(), "jax_at_port": c_jax_at_port.tolist()}
    for b in range(B):
        print(f"cross, video {b}: the port's cost at its pose {c_port_own[b]:.6f}, at JAX's {c_port_at_jax[b]:.6f}; "
              f"JAX's at its pose {c_jax_own[b]:.6f}, at the port's {c_jax_at_port[b]:.6f}", flush=True)
    # each input's gap, the renders in detail, then the swaps
    ig = input_gaps(po, jo)
    rep["input_gaps"] = ig
    print("inputs, largest gap port - JAX: " + ", ".join(f"{k} {v:.3g}" for k, v in ig.items()), flush=True)
    rg = render_gaps(po, jo)
    rep["render_gaps"] = rg
    print("reference renders: " + json.dumps(rg), flush=True)
    flip = silhouette_flips(po, jo)[..., None]
    jax_inputs = {"ref_img": jo["ref_img"], "query": jo["query"], "points": jo["p3d"],
                  "query_pyramid": (jo["q_levels"], jo["q_confs"]), "ref_pyramid": (jo["ref_levels"], jo["ref_confs"]),
                  "observations": (jo["f_ref"], jo["w_ref"], jo["v_ref"])}
    swaps = {name: {name: jax_inputs[name]} for name in SWAPS}
    # the render split in two: JAX's pixels only where the alpha cut flips, or everywhere else
    swaps["ref_img_flips"] = {"ref_img": np.where(flip, jo["ref_img"], po["ref_img"])}
    swaps["ref_img_elsewhere"] = {"ref_img": np.where(flip, po["ref_img"], jo["ref_img"])}
    # the LM's whole input: what align_pyramid sees in JAX
    swaps["lm_inputs"] = {"query_pyramid": jax_inputs["query_pyramid"], "observations": jax_inputs["observations"]}
    rep["swap"] = {}
    for name, swap in swaps.items():
        so = pf.step(jo["R_prev"], jo["t_prev"], swap)
        r, c = gaps(so, jo)
        rep["swap"][name] = {"rot_deg": r.tolist(), "cost_rel": c.tolist(), "lands": lands(so, jo).tolist(),
                             "iters": so["iters"].tolist()}
        print(f"swap {name}: pose gaps {[round(float(x), 3) for x in r]} deg, cost gaps "
              f"{[float(f'{x:.2e}') for x in c]}, at JAX's minimum {lands(so, jo).tolist()}, iterations "
              f"{so['iters'].tolist()} (JAX {jo['iters'].tolist()})", flush=True)
    for name, img in (("port", None), ("jax_render", jo["ref_img"][video])):
        rep[f"basin_{name}"] = bs = basin(pf, jo, video, img)
        print(f"basin, video {video}, {name}: starts moved by k * 1e-6 land at JAX's minimum {bs['lands']}, "
              f"pose gaps {[round(x, 3) for x in bs['rot_deg']]} deg", flush=True)
    if trace is not None:
        rep["trace"] = lm_traces(pf, po, world, jo, trace)
        for pkg in ("port", "jax"):
            for li, lvl in enumerate(rep["trace"][pkg]):
                its = lvl["trace"]
                print(f"trace {pkg}, level {li} (coarse first): {len(its)} it, cost {lvl['cost']:.6f} (the run: "
                      f"{lvl['run_cost']:.6f}); " + " ".join(
                          f"{x['cost']:.5f}/{x['lam']:.0e}/{'a' if x['accepted'] else 'r'}{'D' if x['done'] else ''}"
                          for x in its), flush=True)
    rep["seconds"] = time.perf_counter() - t_start
    print(json.dumps(rep), flush=True)


def lm_traces(pf, po, world, jo, video: int) -> dict:
    """Video ``video``'s LM in both packages, level by level: each iteration's
    candidate cost, lambda, accepted and done, from the same level inputs as
    the runs above (the port's and JAX's own)."""
    out = {"port": port_lm_trace(pf, po, video), "jax": jax_lm_trace(world, jo, video)}
    for pkg, o in (("port", po), ("jax", jo)):
        for li, lvl in enumerate(out[pkg]):
            lvl["run_cost"] = float(o["lvl_cost"][li][video])
    return out


def port_lm_trace(pf, po, video: int) -> list:
    """The port's align_pyramid for one problem, with align_level's body
    unrolled here and recorded (pixtrack_tpu_torch/align/lm.py)."""
    import torch

    from pixtrack_tpu_torch.align import lm
    from pixtrack_tpu_torch.geometry import Pose

    cfg = pf.run.align_cfg
    levels = [lm.LevelData(p3d=d.p3d, f_ref=d.f_ref[video], w_ref=d.w_ref[video], mask=d.mask[video],
                           fmap=d.fmap[video], conf=d.conf[video], scale=d.scale) for d in po["levels"]]
    T_init = Pose(po["T"].R[video], po["T"].t[video])
    T, rec = T_init, []
    for li, data in enumerate(reversed(levels)):
        if li > 0:
            c_carry, _ = lm.residual_cost(T, data, pf.run.camera, cfg)
            c_init, _ = lm.residual_cost(T_init, data, pf.run.camera, cfg)
            T = T_init.where(c_init < c_carry, T)
        rec.append(_lm_record(lambda TT: lm._evaluate(TT, data, pf.run.camera, cfg, True),
                              lambda H, g, lam: lm._solve(H, g, lam, cfg), T, cfg, torch_mode=True))
        T = rec[-1]["T"]
        rec[-1]["T"] = None
    return rec


def jax_lm_trace(world, jo, video: int) -> list:
    """JAX's align_pyramid for one problem, with align_level's while-loop body
    run step by step from Python (pixtrack_tpu/align/lm.py: the same
    evaluate and solve, through the packed map)."""
    import jax
    import jax.numpy as jnp

    from pixtrack_tpu.align import lm
    from pixtrack_tpu.align.interpolate import interpolate_packed
    from pixtrack_tpu.geometry.pose import Pose

    cfg, camera = world["cfg"], world["camera"]
    extr = world["tracker"].refiner.extractor
    levels = []
    for lvl in range(len(jo["q_levels"])):
        s = 1.0 / extr.scales[lvl]
        levels.append(lm.LevelData(p3d=jnp.asarray(jo["p3d"]), f_ref=jnp.asarray(jo["f_ref"][lvl][video]),
                                   w_ref=jnp.asarray(jo["w_ref"][lvl][video]), mask=jnp.asarray(jo["v_ref"][lvl][video]),
                                   fmap=jnp.asarray(jo["q_levels"][lvl][video]),
                                   conf=jnp.asarray(jo["q_confs"][lvl][video]), scale=jnp.asarray([s, s], jnp.float32)))

    def make_eval(data):
        packed, _ = lm._pack_level(data)

        @jax.jit
        def evaluate(R, t):
            T = Pose.from_Rt(R, t)
            p_cam = T.transform(data.p3d)
            p2d_img, visible = camera.project(p_cam)
            p2d = p2d_img * data.scale
            vals, grad, in_map = interpolate_packed(packed, p2d, compute_grad=True)
            f_q, cq, grad = vals[:, :-1], vals[:, -1], grad[:, :-1]
            r = f_q - data.f_ref
            valid = data.mask & visible & in_map
            e2 = jnp.sum(r * r, axis=-1)
            w_static, w = lm._point_weights(e2, cq, valid, data, cfg)
            cost = lm._mean_cost(e2, w_static, valid, cfg)
            J_pix = lm._pixel_pose_jacobian(p_cam, camera, data.scale)
            G = jnp.einsum("nca,ncb->nab", grad, grad)
            gr = jnp.einsum("nca,nc->na", grad, r)
            M = jnp.einsum("nab,nbk->nak", G * w[:, None, None], J_pix)
            return cost, jnp.einsum("nak,na->k", J_pix, gr * w[:, None]), jnp.einsum("nak,nal->kl", J_pix, M), \
                jnp.sum(valid)

        return lambda T: evaluate(T.R, T.t)

    @jax.jit
    def solve(H, g, lam):
        H_damped = H + (lam * jnp.diagonal(H) + cfg.eps) * jnp.eye(6, dtype=H.dtype)
        delta = -jax.scipy.linalg.solve(H_damped, g, assume_a="pos")
        return jnp.where(jnp.isfinite(delta), delta, 0.0)

    T_init = Pose.from_Rt(jnp.asarray(jo["R_prev"][video]), jnp.asarray(jo["t_prev"][video]))
    T, rec = T_init, []
    for li, data in enumerate(reversed(levels)):
        if li > 0:
            c_carry, _ = lm.residual_cost(T, data, camera, cfg)
            c_init, _ = lm.residual_cost(T_init, data, camera, cfg)
            T = T_init if bool(c_init < c_carry) else T
        rec.append(_lm_record(make_eval(data), solve, T, cfg, torch_mode=False))
        T = rec[-1]["T"]
        rec[-1]["T"] = None
    return rec


def _lm_record(evaluate, solve, T_init, cfg, torch_mode: bool) -> dict:
    """align_level's deferred-accept loop for one problem, on either package's
    evaluate and solve and in its arithmetic, recording every iteration."""
    if torch_mode:
        import torch

        lam = torch.tensor(cfg.lambda_init, dtype=torch.float32)
        clip = lambda x: x.clamp(cfg.lambda_min, cfg.lambda_max)  # noqa: E731
        norm = lambda g: torch.linalg.norm(g, dim=-1)  # noqa: E731
    else:
        import jax.numpy as jnp

        lam = jnp.asarray(cfg.lambda_init, jnp.float32)
        clip = lambda x: jnp.clip(x, cfg.lambda_min, cfg.lambda_max)  # noqa: E731
        norm = jnp.linalg.norm
    Pose = type(T_init)
    c_best, g_best, H_best, nv0 = evaluate(T_init)
    nv_floor = cfg.min_valid_frac * (nv0.float() if torch_mode else jnp.asarray(nv0, jnp.float32))
    T_best = T_init
    T_cand = T_init.retract(solve(H_best, g_best, lam))
    stall, its = 0, [{"cost": float(c_best), "lam": float(lam), "accepted": True, "done": False}]
    for _ in range(1, cfg.num_iters):
        c, g, H, nv = evaluate(T_cand)
        accept = bool((c < c_best) & (nv >= nv_floor))
        improved = bool(c < c_best * (1.0 - cfg.cost_rel_tol))
        if accept:
            T_best, c_best, g_best, H_best = T_cand, c, g, H
        lam = clip(lam * cfg.lambda_down if accept else lam * cfg.lambda_up)
        delta = solve(H_best, g_best, lam)
        T_cand = T_best.retract(delta)
        dR, dt = Pose.exp(delta).magnitude()
        stall = 0 if improved else stall + 1
        done = (bool(norm(g_best) < cfg.grad_stop_criteria)
                or (accept and bool(dt < cfg.dt_stop_criteria) and bool(dR < cfg.dR_stop_criteria))
                or (cfg.stagnation_iters > 0 and stall >= cfg.stagnation_iters))
        its.append({"cost": float(c), "lam": float(lam), "accepted": accept, "done": done,
                    "dR": float(dR), "dt": float(dt)})
        if done:
            break
    return {"T": T_best, "cost": float(c_best), "iters": len(its), "trace": its}


def run_jax_basin(frame: int, video: int):
    """JAX's own step (make_production_video_tracker, jitted, B = 8) on
    video ``video``'s frame from the npz's previous pose moved by k * 1e-6
    along x, k = 0..7: where each start lands against the stored pose."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    from stepwise_mesh_jax import jax_world

    import jax.numpy as jnp

    from pixtrack_tpu.align.lm import AlignConfig
    from pixtrack_tpu.parallel.mesh import make_mesh
    from pixtrack_tpu.parallel.video import make_production_video_tracker

    tracker, frames, _, _, _ = jax_world(frame + 1, "bf16")
    tracker.testbed.n_coarse, tracker.testbed.n_fine = 96, 0
    run = make_production_video_tracker(make_mesh(8, tp=1), tracker.testbed, tracker.nerf2sfm,
                                        tracker.refiner.extractor, tracker.scene, tracker.camera,
                                        reference_scale=0.5, align_cfg=AlignConfig(num_iters=ITERS))
    ref = np.load(REPO / "scripts_dev" / "video_batch_jax.npz")
    R = np.repeat(ref["R"][frame - 1][video][None], B, 0)
    t = np.repeat(ref["t"][frame - 1][video][None], B, 0)
    t[:, 0] += np.arange(B, dtype=np.float32) * np.float32(1e-6)
    query = np.asarray(frames[frame][1], np.float32) / 255.0
    R1, _, c1, _ = (np.asarray(v) for v in run(jnp.asarray(R), jnp.asarray(t),
                                                jnp.asarray(np.broadcast_to(query[None], (B, *query.shape)))))
    rot = [rot_deg(R1[k], ref["R"][frame][video]) for k in range(B)]
    stored = float(ref["cost"][frame][video])
    print(f"JAX's basin, video {video}, frame {frame}: starts moved by k * 1e-6 land at its stored pose "
          f"{[bool(r <= POSE_DEG) for r in rot]}, pose gaps {[round(r, 3) for r in rot]} deg, costs "
          f"{[round(float(c), 6) for c in c1]} (stored {stored:.6f})", flush=True)
    print(json.dumps({"frame": frame, "video": video, "rot_deg": rot, "cost": c1.tolist(), "stored_cost": stored}))


def run_render(frame: int, cache):
    """The reference renders of JAX's frame against the port's at the same
    poses (``render_gaps``), from the cache alone."""
    import torch

    from pixtrack_tpu_torch.geometry import Pose

    jo = load_flat(cache)
    pf = PortFrame(frame)
    with torch.no_grad():
        img, alpha = pf.render(Pose(torch.as_tensor(jo["R_prev"]).float(), torch.as_tensor(jo["t_prev"]).float()))
    print(json.dumps(render_gaps({"ref_img": img.numpy(), "ref_alpha": alpha.numpy()}, jo)), flush=True)


def run_unet(frame: int, cache):
    """The UNet's share of the split, on the images JAX's frame kept (each
    video's masked query and reference render):

    - the extractor's pyramids (L2-normalised feature maps): JAX's inside
      its step against JAX's extractor jitted alone, and the port's against
      both;
    - the raw UNet on each image, as the bf16 parity test runs it
      (tests/test_torch_features.py::test_unet_bf16_shipped_weights: JAX's
      ``UNetExtractor().apply`` jitted, the port's bf16 model, one image a
      call), by that test's measures: every feature map and confidence
      within 0.07, their mean gap at most 2.5e-3, and >= 70 % of each
      feature map's values equal."""
    import jax
    import jax.numpy as jnp
    import torch

    from pixtrack_tpu.features.train import load_unet_weights as jload_unet
    from pixtrack_tpu.features.unet import UNetExtractor as JUNet
    from pixtrack_tpu_torch.features.unet import load_unet_weights

    jo = load_flat(cache)
    ext = jax_world_of(frame)["tracker"].refiner.extractor.traced
    alone = jax.jit(jax.vmap(ext))
    pf = PortFrame(frame)
    rep = {}

    def measures(a, b):
        d = [np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)) for x, y in zip(a, b)]
        return {"max": [float(x.max()) for x in d], "mean": [float(x.mean()) for x in d],
                "equal": [float((x == 0).mean()) for x in d]}

    def show(key):
        m = rep[key]
        print(f"{key} (level by level): max {[round(x, 4) for x in m['max']]}, mean "
              f"{[float(f'{x:.2e}') for x in m['mean']]}, equal {[round(x, 3) for x in m['equal']]}", flush=True)

    for name, img, levels in (("query", jo["query"], jo["q_levels"]), ("reference", jo["ref_img"], jo["ref_levels"])):
        ja = [np.asarray(x, np.float32) for x in alone(jnp.asarray(img)).levels]
        with torch.no_grad():
            pt = [x.float().numpy() for x in pf.run.extractor(torch.as_tensor(np.ascontiguousarray(img))).levels]
        for pair, (a, b) in (("jax_in_step_vs_jax_alone", (levels, ja)), ("port_vs_jax", (pt, ja))):
            rep[f"pyramid_{name}_{pair}"] = measures(a, b)
            show(f"pyramid_{name}_{pair}")

    weights = REPO / "assets" / "unet_basin.npz"
    params = jload_unet(weights)[1]
    japply = jax.jit(JUNet().apply)
    model = load_unet_weights(weights, device="cpu", dtype=torch.bfloat16)
    for name, imgs in (("query", jo["query"]), ("reference", jo["ref_img"])):
        for v in range(B):
            pj = japply(params, jnp.asarray(imgs[v])[None])
            with torch.no_grad():
                pt = model(torch.as_tensor(np.ascontiguousarray(imgs[v]))[None])
            fm = measures(pj["feature_maps"], [x.float().numpy() for x in pt["feature_maps"]])
            cf = measures(pj["confidences"], [x.float().numpy() for x in pt["confidences"]])
            rep[f"raw_{name}_{v}"] = m = {"feature_maps": fm, "confidences": cf,
                                          "within_test": bool(max(fm["max"] + cf["max"]) <= 0.07
                                                              and max(fm["mean"] + cf["mean"]) <= 2.5e-3
                                                              and min(fm["equal"]) >= 0.7)}
            print(f"raw UNet, {name} of video {v}: feature maps max {[round(x, 4) for x in fm['max']]}, mean "
                  f"{[float(f'{x:.2e}') for x in fm['mean']]}, equal {[round(x, 3) for x in fm['equal']]}; "
                  f"confidences max {[round(x, 4) for x in cf['max']]}; within the parity test's bounds "
                  f"{m['within_test']}", flush=True)
    print(json.dumps(rep), flush=True)


SPREAD_PORT = REPO / "scripts_dev" / "video_split_port.json"


def jax_start_medians(ref, v: int) -> dict:
    """JAX's rotation median of video ``v`` at each start k the npz holds."""
    out = {0: float(ref["rot_median_deg"][v])}
    for name in ref.files:
        if name.startswith("rot_median_deg_k"):
            out[int(name[len("rot_median_deg_k"):])] = float(ref[name][v])
    return dict(sorted(out.items()))


def judge(report=None):
    """Each video of ``report`` (``SPREAD_PORT``'s layout: n_frames and per
    video the port's medians at k = 0, 1, ...) against JAX's starts in the
    npz: the port's k = 0 gap to JAX's k = 0 against the larger of JAX's
    spread and the port's spread over k >= 1, and the gap between the two
    sets' medians against the larger of the whole spreads."""
    report = report or json.loads(SPREAD_PORT.read_text())
    ref = np.load(REPO / "scripts_dev" / "video_batch_jax.npz")
    rep = {"n_frames": report["n_frames"], "videos": {}}
    for v, m in report["videos"].items():
        m = np.asarray(m, np.float64)
        jm = jax_start_medians(ref, int(v))
        j = np.asarray(list(jm.values()))
        jax_spread, port_spread_rest = float(j.max() - j.min()), float(m[1:].max() - m[1:].min())
        spread_k0 = max(jax_spread, port_spread_rest)
        gap_k0 = float(m[0] - j[0])
        spread_all = max(jax_spread, float(m.max() - m.min()))
        gap_sets = float(np.median(m) - np.median(j))
        rep["videos"][v] = {"port_medians": m.tolist(), "jax_medians": jm, "jax_spread": jax_spread,
                            "port_spread_k1_on": port_spread_rest, "gap_k0": gap_k0, "fault_k0": gap_k0 > spread_k0,
                            "gap_sets": gap_sets, "spread_all": spread_all, "fault_sets": gap_sets > spread_all}
        print(f"video {v}: the port's medians over k = 0..{len(m) - 1} {[round(float(x), 3) for x in m]} deg, JAX's "
              f"at k = {list(jm)} {[round(float(x), 3) for x in j]}; the port's k = 0 against JAX's {gap_k0:+.3f} deg, the "
              f"larger of JAX's spread {jax_spread:.3f} and the port's over k >= 1 {port_spread_rest:.3f}: "
              f"{'a fault' if gap_k0 > spread_k0 else 'within'}; the sets' medians {gap_sets:+.3f} deg against the "
              f"larger whole spread {spread_all:.3f}: {'a fault' if gap_sets > spread_all else 'within'}", flush=True)
    print(json.dumps(rep), flush=True)
    return rep


def run_spread(n_frames: int, videos, starts: int, device: str = "cpu", out_path: Path = SPREAD_PORT):
    """The port's ``videos`` over ``n_frames`` frames, each from ``starts``
    starts moved by k * 1e-6 along x (k = 0..starts-1, phase 7's
    perturbation), all of them one batch (len(videos) * starts problems,
    each refined alone by the batched LM) on ``device``: each video's
    rotation median at each start (and, under ``frames``, its error at each
    frame), written to ``out_path`` (``SPREAD_PORT`` by default) and judged
    (``judge``)."""
    import torch

    import chip_smoke
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.parallel import make_production_video_tracker, track_video_batch

    torch.set_grad_enabled(False)
    ref = np.load(REPO / "scripts_dev" / "video_batch_jax.npz")
    if device != "cpu":
        from pixtrack_tpu_torch.nerf import fused_mlp

        fused_mlp.build_kernels()
    a = chip_smoke.mesh_assets(torch.device(device), n_frames)
    tb = a.testbed
    tb.n_coarse, tb.n_fine = 96, 0
    run = make_production_video_tracker(tb, a.n2s, a.extractor, a.scene, a.camera, reference_scale=0.5,
                                        align_cfg=AlignConfig(num_iters=ITERS))
    pairs = [(v, k) for v in videos for k in range(starts)]
    video = torch.stack([torch.as_tensor(img) for _, img in a.frames[:n_frames]]).float() / 255.0
    batch = video[None].expand(len(pairs), *video.shape)
    R0 = np.stack([ref["R0"][v] for v, _ in pairs])
    t0 = np.stack([ref["t0"][v] for v, _ in pairs])
    t0[:, 0] += np.asarray([k for _, k in pairs], np.float32) * np.float32(1e-6)
    gt_R = [T.R.cpu().numpy() for T in a.gt[:n_frames]]
    t_start = time.perf_counter()
    out = track_video_batch(run, R0, t0, batch)
    rot = np.asarray([[rot_deg(out["R"][f, i], gt_R[f]) for i in range(len(pairs))] for f in range(n_frames)])
    med = np.median(rot, axis=0)
    print(f"the port, {len(pairs)} problems (video, k) {pairs} over {n_frames} frames: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    report = {"n_frames": n_frames, "device": device,
              "videos": {str(v): [float(med[i]) for i, (vv, _) in enumerate(pairs) if vv == v] for v in videos},
              "frames": {str(v): [rot[:, i].round(4).tolist() for i, (vv, _) in enumerate(pairs) if vv == v]
                         for v in videos}}
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(report, indent=1) + "\n")
    judge(report)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=("all", "jaxbasin", "render", "unet", "spread", "judge"))
    ap.add_argument("n", type=int, nargs="?", default=None, help="the frame (all: 8) or the frames (spread: 20)")
    ap.add_argument("--trace", type=int, default=None, help="trace this video's LM in both packages")
    ap.add_argument("--video", type=int, default=0, help="the video whose start is moved (basin)")
    ap.add_argument("--cache", default=None, help="npz of JAX's frame and its inputs: written once, then read")
    ap.add_argument("--videos", type=int, nargs="+", default=[2, 3], help="spread: the videos")
    ap.add_argument("--starts", type=int, default=4, help="spread: starts a video")
    ap.add_argument("--device", default="cpu", help="spread: the port's device (cuda on the card)")
    ap.add_argument("--out", default=str(SPREAD_PORT), help="spread: where the port's medians go; judge: read")
    args = ap.parse_args()
    if args.part == "all":
        run_all(args.n or 8, args.trace, args.cache, args.video)
    elif args.part == "jaxbasin":
        run_jax_basin(args.n or 8, args.video)
    elif args.part == "render":
        run_render(args.n or 8, args.cache)
    elif args.part == "unet":
        run_unet(args.n or 8, args.cache)
    elif args.part == "spread":
        run_spread(args.n or 20, args.videos, args.starts, args.device, Path(args.out))
    else:
        judge(json.loads(Path(args.out).read_text()))


if __name__ == "__main__":
    main()
