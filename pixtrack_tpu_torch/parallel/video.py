"""Offline video tracking at batch: every video's frame k refined in one step.

Port of ``pixtrack_tpu/parallel/video.py``. The JAX package shards a batch
of frames over the device mesh's ``dp`` axis and vmaps the steady-state
frame (mask -> reference render -> observe -> query pyramid -> LM) over it.
On one card the ``dp`` axis is a leading batch axis of the tensors:

- the B reference renders are ONE ray batch of B * rH * rW rays through
  ``render_rays``, so a ``DistilledField`` with ``n_fine == 0`` renders all
  of them in one launch of K1 (``fused_march_render``); a field with
  ``n_fine > 0`` takes the staged render through K2, and any other field its
  plain render, as ``render_rays`` routes it;
- the splat mask, both feature pyramids (one extractor call each for the B
  references and the B queries), the observation and the LM
  (``align_pyramid`` over B problems, each with its own carry and iteration
  count) take the batch as one.

The caller gives each video's initial pose; ``track_video_batch`` chains
the steps over time, each video from its own previous estimate. Over
several cards (``mesh``, ``parallel/mesh.py``) every rank runs its own
``VideoStep`` on its card for its B / dp videos, its references still in
one launch of K1 a step, and the ranks' results are broadcast to every
rank in the one-process order.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from pixtrack_tpu_torch.align.lm import AlignConfig, align_pyramid
from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.nerf.render import RenderConfig, rays_from_camera, render_rays
from pixtrack_tpu_torch.tracking.mask import splat_object_mask


class VideoStep:
    """``run(R (B, 3, 3), t (B, 3), queries (B, H, W, 3)) -> (R', t', cost
    (B,), iters (B,))``: one batched steady-state refine. ``stage_timer``, a
    callable(name) -> context manager, wraps each stage when set
    (``reference_render``, ``unet``, ``observation``, ``lm``)."""

    def __init__(self, field, extractor, p3d, camera: Camera, ref_camera: Camera, aabb,
                 c2w_nerf_of: Callable[[Pose], torch.Tensor], align_cfg: AlignConfig, rcfg: RenderConfig,
                 background: float, black_outside: bool, device):
        self.field, self.extractor = field, extractor
        self.device = device
        self.p3d = torch.as_tensor(p3d, dtype=torch.float32, device=device)
        self.pmask = torch.ones(self.p3d.shape[0], dtype=torch.bool, device=device)
        self.camera, self.ref_camera = camera.to(device), ref_camera.to(device)
        self.H, self.W = int(round(float(camera.height))), int(round(float(camera.width)))
        self.rH, self.rW = int(round(float(ref_camera.height))), int(round(float(ref_camera.width)))
        # intrinsics as Python floats, resolved once (the JAX builder's rfx, rfy, rcx, rcy)
        self._ref_f = [float(v) for v in ref_camera.f]
        self._ref_c = [float(v) for v in ref_camera.c]
        self.aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
        self.c2w_nerf_of = c2w_nerf_of
        self.align_cfg, self.rcfg = align_cfg, rcfg
        self.background, self.black_outside = background, black_outside
        self.stage_timer = None

    def _stage(self, name: str):
        return contextlib.nullcontext() if self.stage_timer is None else self.stage_timer(name)

    def render_references(self, T: Pose) -> torch.Tensor:
        """(B, rH, rW, 3) reference renders at the B poses, one ray batch."""
        rays = [rays_from_camera(self.c2w_nerf_of(Pose(T.R[b], T.t[b])), *self._ref_f, *self._ref_c,
                                 self.rW, self.rH) for b in range(T.R.shape[0])]
        out = render_rays(self.field, torch.cat([o for o, _ in rays]), torch.cat([d for _, d in rays]),
                          self.aabb, self.rcfg)
        alpha = out["alpha"][:, None]
        rgb = out["rgb"] + (1.0 - alpha) * self.background
        if self.black_outside:
            # the production convention (tracking/render_bridge.py, tracking/fused.py): the
            # background composited into the object's interior, black outside the silhouette
            rgb = torch.where(alpha > 1e-2, rgb, 0.0)
        return rgb.reshape(-1, self.rH, self.rW, 3)

    @torch.no_grad()
    def __call__(self, R, t, queries):
        T = Pose(torch.as_tensor(R, dtype=torch.float32, device=self.device),
                 torch.as_tensor(t, dtype=torch.float32, device=self.device))
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        with self._stage("reference_render"):
            ref_imgs = self.render_references(T)
        with self._stage("mask"):
            q = queries * splat_object_mask(T, self.camera, self.p3d, (self.H, self.W))[..., None]
        with self._stage("unet"):
            ref_pyr = self.extractor(ref_imgs)
            pyr = self.extractor(q)
        with self._stage("observation"):
            f_ref, w_ref, v_ref = observe_points(ref_pyr, T, self.ref_camera, self.p3d, self.pmask)
            levels = build_level_data(pyr, f_ref, w_ref, v_ref, self.p3d, self.pmask)
        with self._stage("lm"):
            final, states = align_pyramid(T, levels, self.camera, self.align_cfg)
            iters = sum(s.num_iters for s in states)
        return final.T.R, final.T.t, final.cost, iters


def make_video_tracker(
    field, extractor, p3d, camera: Camera, ref_camera: Camera, aabb,
    c2w_nerf_of: Callable[[Pose], torch.Tensor], align_cfg: Optional[AlignConfig] = None,
    rcfg: Optional[RenderConfig] = None, background: float = 1.0, black_outside: bool = False,
    device=None,
) -> VideoStep:
    """``make_sharded_video_tracker`` without the mesh: the batched step over
    ``field`` (the port's fields carry their parameters). ``extractor`` maps
    (B, H, W, 3) images to a batched pyramid; ``c2w_nerf_of(T)`` maps one SfM
    w2c pose to its NeRF-space (4, 4) camera-to-world matrix. ``device``
    None is the CUDA card."""
    from pixtrack_tpu_torch._device import resolve

    return VideoStep(field, extractor, p3d, camera, ref_camera, aabb, c2w_nerf_of,
                     align_cfg or AlignConfig(), rcfg or RenderConfig(n_coarse=48, n_fine=0, perturb=False),
                     background, black_outside, resolve(device))


def make_production_video_tracker(
    testbed, nerf2sfm, extractor, scene, camera: Camera, reference_scale: float = 0.5,
    n_points: int = 4096, align_cfg: Optional[AlignConfig] = None, rcfg: Optional[RenderConfig] = None,
) -> VideoStep:
    """The batched step from production assets: the testbed's render field
    (baked or distilled, else its vertex field), the object's
    ``NerfTransform``, up to ``n_points`` of the SfM points (the JAX
    package's ``default_rng(0)`` subsample, so both use the same points) and
    the extractor; the reference camera is the first image's at
    ``reference_scale``. Runs on the testbed's device (CLI ``track-batch``)."""
    from pixtrack_tpu_torch.geometry import nerf_transform

    dev = testbed.device
    field = testbed._baked if testbed._baked is not None else testbed.field
    aabb = np.asarray([testbed.render_aabb.min, testbed.render_aabb.max], np.float32)
    xyz = np.asarray(scene.xyz, np.float32)
    if len(xyz) > n_points:
        xyz = xyz[np.random.default_rng(0).choice(len(xyz), n_points, replace=False)]
    cam_id = scene.images[int(scene.image_ids[0])].camera_id
    ref_camera = scene.camera(cam_id).scale(reference_scale)

    def t32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    PW, CCAM = t32(nerf_transform.P_W), t32(nerf_transform.C_CAM)
    R3, centroid, totp = t32(nerf2sfm.R3), t32(nerf2sfm.centroid), t32(nerf2sfm.totp)
    scale = float(nerf2sfm.scale)
    bottom = t32([[0.0, 0.0, 0.0, 1.0]])

    def c2w_nerf_of(T: Pose) -> torch.Tensor:
        Tinv = T.inv()
        t = R3 @ ((PW @ Tinv.t - centroid) * scale) - totp
        return torch.cat([torch.cat([R3 @ (PW @ Tinv.R @ CCAM), t[:, None]], dim=1), bottom], dim=0)

    return make_video_tracker(
        field, getattr(extractor, "traced", extractor), xyz, camera, ref_camera, aabb, c2w_nerf_of,
        align_cfg=align_cfg,
        rcfg=rcfg or RenderConfig(n_coarse=testbed.n_coarse, n_fine=testbed.n_fine, perturb=False),
        black_outside=True,  # the query / reference domain of render_nerf_view
        device=dev,
    )


def track_video_batch(run: VideoStep, R0, t0, videos, mesh=None) -> dict:
    """Chain the batched step over time for B videos in lockstep.

    ``videos``: (B, T, H, W, 3) float in [0, 1] (a shorter video padded by
    repeating its last frame), numpy or a tensor; uploaded once. Each
    timestep refines every video's frame k from its own frame k-1 estimate;
    one host sync at the end. Returns numpy arrays stacked (T, B, ...): R,
    t, cost, num_iters.

    ``mesh``: every rank of its ``dp`` group calls this with the same
    arguments and its ``run`` on ``mesh.device``; B is padded to a multiple
    of dp by repeating the last video, rank d tracks videos [d B', (d + 1)
    B') of the padded B' a rank, and every rank returns all B videos' arrays
    (the padding dropped)."""
    dev = run.device
    R0 = torch.as_tensor(np.asarray(R0, np.float32) if not torch.is_tensor(R0) else R0).float()
    t0 = torch.as_tensor(np.asarray(t0, np.float32) if not torch.is_tensor(t0) else t0).float()
    B = R0.shape[0]
    if mesh is not None:
        per = -(-B // mesh.dp)
        keep = [min(b, B - 1) for b in range(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)]
        R0, t0, videos = R0[keep], t0[keep], videos[keep]
    videos = torch.as_tensor(videos, dtype=torch.float32, device=dev)
    R, t = R0.to(dev), t0.to(dev)
    out = {"R": [], "t": [], "cost": [], "num_iters": []}
    for k in range(videos.shape[1]):
        R, t, cost, iters = run(R, t, videos[:, k])
        for name, v in zip(out, (R, t, cost, iters)):
            out[name].append(v)
    out = {name: torch.stack(v) for name, v in out.items()}
    if mesh is not None:
        out = {name: _from_every_rank(v, mesh)[:, :B] for name, v in out.items()}
    return {name: v.cpu().numpy() for name, v in out.items()}


def _from_every_rank(v: torch.Tensor, mesh) -> torch.Tensor:
    """(T, B', ...) of each rank of the ``dp`` group -> (T, dp B', ...) on
    every rank, rank d's block at [d B', (d + 1) B'): one broadcast a rank."""
    import torch.distributed as dist

    blocks = []
    for d, src in enumerate(mesh.dp_ranks()):
        block = v.contiguous() if d == mesh.dp_rank else torch.empty_like(v, memory_format=torch.contiguous_format)
        dist.broadcast(block, src=src, group=mesh.dp_group)
        blocks.append(block)
    return torch.cat(blocks, dim=1)
