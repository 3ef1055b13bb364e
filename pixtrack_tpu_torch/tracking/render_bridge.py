"""Render the NeRF at an SfM-space pose through the Testbed.

Port of ``pixtrack_tpu/tracking/render_bridge.py``.
"""

from __future__ import annotations

import numpy as np

from pixtrack_tpu_torch.nerf.testbed import RenderMode


def render_nerf_view(
    testbed, nerf2sfm, T_w2c, camera, spp: int = 8, depth: bool = False,
    alpha_threshold: float = 1e-2, exact_intrinsics: bool = True, return_alpha: bool = False,
):
    """uint8 (H, W, 3) in Shade mode (black where alpha <= threshold), or
    float32 NeRF-unit depth in Depth mode; optionally also the alpha map.
    Without ``exact_intrinsics`` the Testbed derives its camera from the
    horizontal field of view, principal point at the image centre."""
    c2w_sfm = T_w2c.inv().to_4x4().detach().cpu().numpy().astype(np.float64)
    nerf_pose = nerf2sfm.pose_sfm_to_nerf(c2w_sfm)
    w = int(round(float(camera.width)))
    h = int(round(float(camera.height)))
    if exact_intrinsics:
        testbed.override_intrinsics = (
            float(camera.f[0]), float(camera.f[1]), float(camera.c[0]), float(camera.c[1])
        )
    else:
        testbed.override_intrinsics = None
        testbed.fov_axis = 0
        testbed.fov = float(np.rad2deg(2.0 * np.arctan2(w / 2.0, float(camera.f[0]))))
    testbed.set_nerf_camera_matrix(nerf_pose[:3, :])
    testbed.render_mode = RenderMode.Depth if depth else RenderMode.Shade
    img = testbed.render(w, h, spp=spp, linear=True)
    if depth:
        if return_alpha:
            return img[..., 0].astype(np.float32), img[..., 3].astype(np.float32)
        return img[..., 0].astype(np.float32)
    alpha = img[..., 3]
    rgb = np.where(alpha[..., None] > alpha_threshold, img[..., :3], 0.0)
    out = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    if return_alpha:
        return out, alpha.astype(np.float32)
    return out
