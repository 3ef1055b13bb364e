"""NeRF training captures: the transforms.json loader, every ray of a
capture, and analytic test scenes.

Port of ``pixtrack_tpu/nerf/dataset.py``. Images stay on the host (numpy);
``all_rays`` builds the rays on a device. PNG frames are read by the port's
own decoder; other formats by a library imported where it is needed.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.nerf.render import _to_grid, ray_aabb_intersect, rays_from_camera
from pixtrack_tpu_torch.utils.io import _read_rgb


def _downscale_area(img: np.ndarray, k: int) -> np.ndarray:
    """uint8 (H, W, 3) -> (H // k, W // k, 3): the mean of each k x k block,
    rounded half up to uint8 (cv2.INTER_AREA at an integer factor)."""
    h, w = img.shape[0] // k, img.shape[1] // k
    blocks = img[: h * k, : w * k].reshape(h, k, w, k, -1).astype(np.int64)
    return ((blocks.sum(axis=(1, 3)) * 2 + k * k) // (2 * k * k)).astype(np.uint8)


@dataclasses.dataclass
class NerfDataset:
    images: np.ndarray  # (N, H, W, 3) float32 linear [0, 1]
    c2w: np.ndarray  # (N, 4, 4) NeRF-space OpenGL camera-to-world
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    aabb_scale: int = 4

    @property
    def n_images(self):
        return len(self.images)

    @classmethod
    def from_transforms(cls, transforms_path, downscale: int = 1) -> "NerfDataset":
        """Load images and poses from a transforms.json (instant-ngp layout).
        Its principal point is corner-convention; the dataset's is
        index-centred (0.5 less)."""
        transforms_path = Path(transforms_path)
        meta = json.loads(transforms_path.read_text())
        root = transforms_path.parent
        images, poses = [], []
        for fr in meta["frames"]:
            p = root / fr["file_path"]
            if not p.exists() and not str(p).lower().endswith((".png", ".jpg", ".jpeg")):
                for ext in (".png", ".jpg", ".jpeg"):
                    if p.with_suffix(ext).exists():
                        p = p.with_suffix(ext)
                        break
            try:
                img = _read_rgb(p)
            except FileNotFoundError:
                continue
            if downscale > 1:
                img = _downscale_area(img, downscale)
            images.append(img.astype(np.float32) / 255.0)
            poses.append(np.asarray(fr["transform_matrix"], np.float64))
        images = np.stack(images)
        poses = np.stack(poses).astype(np.float32)
        H, W = images.shape[1:3]
        if "fl_x" in meta:
            fx, fy = meta["fl_x"] / downscale, meta["fl_y"] / downscale
            cx = meta["cx"] / downscale - 0.5
            cy = meta["cy"] / downscale - 0.5
        else:
            fx = fy = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
            cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
        return cls(images=images, c2w=poses, fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                   width=W, height=H, aabb_scale=int(meta.get("aabb_scale", 4)))

    def all_rays(self, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every ray of the capture, built on ``device`` (None is the CUDA
        card): origins, unit directions (NeRF space) and rgb, each (N*H*W, 3)."""
        device = resolve(device)
        origins, dirs = [], []
        for c2w in self.c2w:
            o, d = rays_from_camera(torch.as_tensor(c2w, dtype=torch.float32, device=device),
                                    self.fx, self.fy, self.cx, self.cy, self.width, self.height)
            origins.append(o)
            dirs.append(d)
        rgbs = torch.as_tensor(self.images.reshape(-1, 3), dtype=torch.float32, device=device)
        return torch.cat(origins), torch.cat(dirs), rgbs


def sphere_scene_T(xT):
    """Analytic test scene, feature-major: xT (3, N) -> (sigma (N,), rgb (3, N))."""
    d = torch.sqrt(((xT - 0.5) ** 2).sum(dim=0))
    sigma = torch.where(d < 0.12, 80.0, 0.0)
    rgb = torch.stack([0.5 + 0.5 * torch.sin(20 * xT[0]), 0.5 + 0.5 * torch.cos(20 * xT[1]),
                       torch.full_like(d, 0.4)])
    return sigma, rgb


def sphere_scene(x_grid):
    """Points-major wrapper: (N, 3) -> (sigma (N,), rgb (N, 3))."""
    sigma, rgbT = sphere_scene_T(x_grid.T)
    return sigma, rgbT.T


def blob_scene_T(xT):
    """Analytic asymmetric test scene (three overlapping balls), feature-major."""
    centers = [(0.5, 0.5, 0.5), (0.58, 0.54, 0.46), (0.45, 0.44, 0.56)]
    radii = (0.10, 0.07, 0.06)
    inside = None
    for (cx, cy, cz), r in zip(centers, radii):
        hit = (xT[0] - cx) ** 2 + (xT[1] - cy) ** 2 + (xT[2] - cz) ** 2 < r * r
        inside = hit if inside is None else (inside | hit)
    sigma = torch.where(inside, 80.0, 0.0)
    rgb = torch.stack([0.5 + 0.5 * torch.sin(40 * xT[0] + 13 * xT[2]), 0.5 + 0.5 * torch.cos(40 * xT[1]),
                       0.5 + 0.5 * torch.sin(25 * (xT[0] + xT[1]))])
    return sigma, rgb


def blob_scene(x_grid):
    """Points-major wrapper: (N, 3) -> (sigma (N,), rgb (N, 3))."""
    sigma, rgbT = blob_scene_T(x_grid.T)
    return sigma, rgbT.T


_FEATURE_MAJOR = {sphere_scene: sphere_scene_T, blob_scene: blob_scene_T}


def make_synthetic_dataset(field_fn, n_views: int = 20, res: int = 64, radius: float = 3.2, seed: int = 0,
                           device=None) -> NerfDataset:
    """Render an analytic scene (``field_fn``: grid points (N, 3) -> (sigma,
    rgb (N, 3))) from ``n_views`` cameras on a sphere looking at the
    NeRF-space origin, 96 midpoint samples a ray, on ``device`` (None is the
    CUDA card)."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    fx = fy = res * 1.1
    cx = cy = (res - 1) / 2.0
    S = 96
    field_T = _FEATURE_MAJOR.get(field_fn)
    aabb = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=device)

    @torch.no_grad()
    def render_view(c2w):
        o, d = rays_from_camera(torch.as_tensor(c2w, device=device), fx, fy, cx, cy, res, res)
        o_g, d_g = _to_grid(o, d)
        t0, t1, hit = ray_aabb_intersect(o_g, d_g, aabb[0], aabb[1])
        t1 = torch.maximum(t1, t0 + 1e-4)
        i = torch.arange(S, dtype=torch.float32, device=device) + 0.5
        ts = t0[:, None] + (t1 - t0)[:, None] * i / torch.full((), float(S), device=device)
        x = (o_g.T[:, :, None] + ts[None] * d_g.T[:, :, None]).reshape(3, -1)
        if field_T is not None:
            sigma, rgbT = field_T(x)
        else:
            sigma, rgb = field_fn(x.T)
            rgbT = rgb.T
        sigma, rgbT = sigma.reshape(-1, S), rgbT.reshape(3, -1, S)
        deltas = torch.diff(ts, dim=-1)
        deltas = torch.cat([deltas, deltas[:, -1:]], dim=-1)
        alpha = 1.0 - torch.exp(-sigma * deltas)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
        w = alpha * trans * hit[:, None]
        out = torch.einsum("rs,crs->rc", w, rgbT) + (1 - w.sum(-1))[:, None]
        return out.reshape(res, res, 3).cpu().numpy()

    images, poses = [], []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        phi = np.deg2rad(rng.uniform(-35, 35))
        center = radius * np.array([np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta)])
        z = center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, center
        images.append(render_view(c2w))
        poses.append(c2w)
    return NerfDataset(images=np.stack(images), c2w=np.stack(poses), fx=fx, fy=fy, cx=cx, cy=cy,
                       width=res, height=res, aabb_scale=1)
