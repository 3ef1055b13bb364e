"""The closed-loop steady-state tracking frame, chained on device tensors.

Port of ``FusedSteadyStep`` and ``run_fused`` from
``pixtrack_tpu/tracking/fused.py``. One frame: relocalize to the upright
pose after a failed frame (or apply the motion model), splat the object
mask into the query, render the reference view in a crop window at the
current estimate (K1), extract both feature pyramids, observe the
geodesic-nearest reference's points with silhouette-interior weights, run
the coarse-to-fine LM and apply the adaptive cost gate. Every step is a
device op on the previous frame's device tensors, so a sequence of frames
needs one host sync at its end.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import nerf_transform
from pixtrack_tpu_torch.align.interpolate import interpolate_scalar
from pixtrack_tpu_torch.align.lm import align_pyramid
from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.rotation import geodesic_distance, quat_to_rotmat
from pixtrack_tpu_torch.nerf.render import RenderConfig, rays_from_camera, render_rays
from pixtrack_tpu_torch.tracking.mask import erode, splat_object_mask


@dataclasses.dataclass
class FusedFrameOut:
    """Per-frame outputs, left on the device until the sequence ends."""

    R: torch.Tensor
    t: torch.Tensor
    ok: torch.Tensor
    cost: torch.Tensor
    num_iters: torch.Tensor
    relocalized: torch.Tensor


class FusedSteadyStep:
    """The steady-state frame of a ``PixTrackTracker`` for a query camera."""

    def __init__(self, tracker, camera: Camera):
        dev = tracker.device
        scene = tracker.scene
        cfg = tracker.config
        self.tracker = tracker
        self.device = dev
        self.camera = camera.to(dev)
        self.H = int(round(float(camera.height)))
        self.W = int(round(float(camera.width)))
        # optional callable(name) -> context manager around each stage
        self.stage_timer = None

        # per-reference packed point selections, one static shape
        ref = tracker.refiner
        ids = [int(i) for i in scene.image_ids]
        packs = [
            scene.pack_points(
                scene.p3d_indices_for_images([i], min_track_length=ref.min_track_length),
                pad_multiple=ref.pad_multiple,
            )
            for i in ids
        ]
        P = max(p.shape[0] for p, _ in packs)
        p3d = np.zeros((len(ids), P, 3), np.float32)
        pmask = np.zeros((len(ids), P), bool)
        for k, (xyz, m) in enumerate(packs):
            p3d[k, : len(xyz)] = xyz
            pmask[k, : len(m)] = m
        self.p3d_pack = torch.as_tensor(p3d, device=dev)
        self.pmask_pack = torch.as_tensor(pmask, device=dev)
        qv = scene.qvecs[[scene._imgidx[i] for i in ids]]
        self.ref_Rs = quat_to_rotmat(torch.as_tensor(qv, dtype=torch.float32, device=dev))
        self.p3d_all = torch.as_tensor(scene.xyz.astype(np.float32), device=dev)

        T0 = scene.pose_w2c(tracker.reference_ids[0], device=dev)
        self.R_up, self.t_up = T0.R, T0.t

        cam_id = scene.images[int(tracker.reference_ids[0])].camera_id
        ref_cam_cpu = scene.camera(cam_id).scale(cfg.reference_scale)
        self.ref_camera = ref_cam_cpu.to(dev)
        self.rW = int(round(float(ref_cam_cpu.width)))
        self.rH = int(round(float(ref_cam_cpu.height)))
        self._ref_f = [float(v) for v in ref_cam_cpu.f]
        self._ref_c = [float(v) for v in ref_cam_cpu.c]

        tb = tracker.testbed
        self.field = tb._baked
        self.render_cfg = RenderConfig(
            n_coarse=tb.n_coarse, n_fine=tb.n_fine,
            min_transmittance=float(tb.nerf.rendering_min_transmittance),
        )
        self.aabb = torch.as_tensor([tb.render_aabb.min, tb.render_aabb.max], dtype=torch.float32, device=dev)
        self.sphere = None if tb._sphere is None else torch.as_tensor(tb._sphere, dtype=torch.float32, device=dev)

        # static crop size covering the cloud's projection at every DB view,
        # with margin; the window's position follows the estimate per frame
        self._crop = None
        if cfg.ref_crop:
            ext_w = ext_h = 0.0
            xyz = torch.as_tensor(scene.xyz.astype(np.float32))
            for i in ids:
                p2d, vis = ref_cam_cpu.world2image(scene.pose_w2c(i), xyz)
                p2d, vis = p2d.numpy(), vis.numpy()
                if vis.sum() < 3:
                    continue
                ext_w = max(ext_w, float(np.ptp(p2d[vis, 0])))
                ext_h = max(ext_h, float(np.ptp(p2d[vis, 1])))
            cw = int(-((1.30 * ext_w + 32) // -16) * 16)
            ch = int(-((1.30 * ext_h + 32) // -16) * 16)
            if 0 < ext_w and cw < self.rW and ch < self.rH and cw * ch < 0.8 * self.rW * self.rH:
                self._crop = (ch, cw)

        n2s = tracker.nerf2sfm

        def t32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        self._PW, self._CCAM = t32(nerf_transform.P_W), t32(nerf_transform.C_CAM)
        self._n2s_R3, self._n2s_centroid = t32(n2s.R3), t32(n2s.centroid)
        self._n2s_totp, self._n2s_scale = t32(n2s.totp), float(n2s.scale)

    def _stage(self, name: str):
        return contextlib.nullcontext() if self.stage_timer is None else self.stage_timer(name)

    def _c2w_nerf(self, T: Pose) -> torch.Tensor:
        """NerfTransform.pose_sfm_to_nerf on device tensors."""
        Tinv = T.inv()
        Rm = self._PW @ Tinv.R @ self._CCAM
        t = self._n2s_R3 @ ((self._PW @ Tinv.t - self._n2s_centroid) * self._n2s_scale) - self._n2s_totp
        top = torch.cat([self._n2s_R3 @ Rm, t[:, None]], dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=top.device)
        return torch.cat([top, bottom], dim=0)

    def _render_ref(self, T: Pose):
        """White-background reference render and alpha at T, thresholded to
        black outside the object; crop-sized with its shifted camera when a
        crop window is set."""
        c2w = self._c2w_nerf(T)
        if self._crop is None:
            ch, cw = self.rH, self.rW
            x0f = y0f = torch.zeros((), device=self.device)
        else:
            ch, cw = self._crop
            p2d, vis = self.ref_camera.world2image(T, self.p3d_all)
            big = 1e9
            cx = 0.5 * (torch.where(vis, p2d[:, 0], big).min() + torch.where(vis, p2d[:, 0], -big).max())
            cy = 0.5 * (torch.where(vis, p2d[:, 1], big).min() + torch.where(vis, p2d[:, 1], -big).max())
            any_vis = vis.any()
            cx = torch.where(any_vis, cx, 0.5 * self.rW)
            cy = torch.where(any_vis, cy, 0.5 * self.rH)
            x0f = torch.clamp(torch.round(cx - 0.5 * cw), 0, self.rW - cw)
            y0f = torch.clamp(torch.round(cy - 0.5 * ch), 0, self.rH - ch)
        o, d = rays_from_camera(c2w, *self._ref_f, *self._ref_c, cw, ch, x0=x0f, y0=y0f)
        out = render_rays(self.field, o, d, self.aabb, self.render_cfg, sphere=self.sphere)
        alpha = out["alpha"]
        rgb = out["rgb"] + (1.0 - alpha[:, None])
        rgb = torch.where(alpha[:, None] > 1e-2, rgb, 0.0).reshape(ch, cw, 3)
        alpha = alpha.reshape(ch, cw)
        if self._crop is None:
            return rgb, alpha, self.ref_camera
        return rgb, alpha, self.ref_camera.crop(torch.stack([x0f, y0f]), [cw, ch])

    def _frame(self, R_prev, t_prev, R_prev2, t_prev2, vel_ok, ok_prev, thresh, query_image):
        cfg = self.tracker.config
        refiner = self.tracker.refiner
        # 1. relocalize on a failed previous frame, else the motion model
        relocalized = ~ok_prev
        use_vel = vel_ok & ok_prev & bool(cfg.motion_model)
        T1 = Pose(R_prev, t_prev)
        Tv = (T1 @ Pose(R_prev2, t_prev2).inv()) @ T1
        t_ext = t_prev + cfg.vel_t_damp * (Tv.t - t_prev)
        R0 = torch.where(relocalized, self.R_up, torch.where(use_vel, Tv.R, R_prev))
        t0 = torch.where(relocalized, self.t_up, torch.where(use_vel, t_ext, t_prev))
        T = Pose(R0, t0)

        # 2. object mask while tracking is good
        with self._stage("mask"):
            mask = splat_object_mask(T, self.camera, self.p3d_all, (self.H, self.W),
                                     dilate_iters=cfg.mask_dilate_iters)
            use_mask = ok_prev & bool(cfg.use_mask)
            q = query_image * torch.where(use_mask, mask, 1.0)[..., None]

        # 3. the geodesic-nearest reference image's point selection
        k = torch.argmin(geodesic_distance(R0[None], self.ref_Rs))
        p3d, pmask = self.p3d_pack[k], self.pmask_pack[k]

        with self._stage("query_unet"):
            pyr = refiner.extractor.traced(q)

        def observe_and_align(T_obs):
            with self._stage("reference_render"):
                ref_img, ref_alpha, ref_cam = self._render_ref(T_obs)
            with self._stage("reference_unet"):
                ref_pyr = refiner.extractor.traced(ref_img)
            with self._stage("observation"):
                f_ref, w_ref, v_ref = observe_points(ref_pyr, T_obs, ref_cam, p3d, pmask)
                interior = erode((ref_alpha > 0.5).float(), size=7)
                wi, _ = interpolate_scalar(interior, ref_cam.world2image(T_obs, p3d)[0])
                w_ref = tuple(w * wi for w in w_ref)
                levels = build_level_data(pyr, f_ref, w_ref, v_ref, p3d, pmask)
            with self._stage("lm"):
                return align_pyramid(T_obs, levels, self.camera, refiner.align_cfg)

        final, states = observe_and_align(T)
        iters = sum(s.num_iters for s in states)
        for _ in range(max(1, int(cfg.refine_rounds)) - 1):
            final, states = observe_and_align(final.T)
            iters = iters + sum(s.num_iters for s in states)

        # 6. adaptive success gate
        ok = torch.isfinite(final.cost) & (final.cost <= thresh) & (final.num_valid >= refiner.min_points_opt)
        return FusedFrameOut(
            R=torch.where(ok, final.T.R, R0), t=torch.where(ok, final.T.t, t0), ok=ok,
            cost=final.cost, num_iters=iters, relocalized=relocalized,
        )

    @torch.no_grad()
    def __call__(self, R, t, ok, thresh, query_image, R_prev=None, t_prev=None, vel_ok=None):
        """One frame from the previous state (R, t, ok); (R_prev, t_prev,
        vel_ok) is the frame before, for the motion model."""
        if R_prev is None:
            R_prev, t_prev = R, t
            vel_ok = torch.tensor(False, device=self.device)
        return self._frame(R, t, R_prev, t_prev, vel_ok, ok, thresh, query_image)


def run_fused(tracker, frames: Sequence[Tuple[str, np.ndarray]], camera: Optional[Camera] = None
              ) -> List[FusedFrameOut]:
    """Frame 0 cold-starts through ``tracker.refine`` (setting the adaptive
    cost threshold); every later frame is one fused frame chained on the
    previous one's device tensors, with one host sync at the end. Returns
    the per-frame outputs of frames[1:]."""
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image

    dev = tracker.device
    name0, img0 = frames[0]
    if camera is None:
        camera = infer_camera_from_image(np.asarray(img0), device=dev)
    tracker.camera = camera.to(dev)
    tracker.cold_start = True
    tracker.refine((name0, np.asarray(img0)))
    thresh = torch.tensor(tracker.cost_threshold or np.inf, dtype=torch.float32, device=dev)

    step = getattr(tracker, "_fused_step", None)
    if step is None or step.camera is not tracker.camera:
        step = FusedSteadyStep(tracker, tracker.camera)
        tracker._fused_step = step
    R, t = tracker.pose.R.to(dev), tracker.pose.t.to(dev)
    ok = torch.tensor(bool(tracker.success), device=dev)

    def as_query(img):
        img = np.asarray(img)
        scale = 255.0 if img.dtype == np.uint8 else 1.0
        return torch.as_tensor(img, device=dev).float() / scale

    outs: List[FusedFrameOut] = []
    R2, t2, vel_ok = R, t, torch.tensor(False, device=dev)
    for _, img in frames[1:]:
        out = step(R, t, ok, thresh, as_query(img), R_prev=R2, t_prev=t2, vel_ok=vel_ok)
        R2, t2, vel_ok = R, t, ok
        R, t, ok = out.R, out.t, out.ok
        outs.append(out)

    for (name, _), out in zip(frames[1:], outs):
        nm = str(name).split("/")[-1]
        okv = bool(out.ok)
        T_out = Pose(out.R, out.t).to_4x4().cpu().numpy()
        tracker.pose_history[nm] = {"success": okv, "T_init": T_out, "T_refined": T_out,
                                    "cost": float(out.cost), "query_path": str(name)}
        tracker.trace.append({"frame": nm, "cost": float(out.cost), "num_iters": int(out.num_iters),
                              "cache_hit": False, "success": okv, "fused": True})
        if bool(out.relocalized):
            tracker.relocalization_count += 1
    tracker.pose = Pose(R, t)
    tracker.success = bool(ok)
    return outs
