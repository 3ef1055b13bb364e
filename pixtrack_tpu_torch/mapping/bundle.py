"""Joint bundle adjustment: poses and structure, dense-J Levenberg-Marquardt.

Port of ``pixtrack_tpu/mapping/bundle.py`` (the COLMAP bundle-adjuster role).
At the object-rig scale (tens of cameras, hundreds to a few thousand
points) the full dense Jacobian (2M, D) is built by scattering each
observation's analytic blocks, and the normal equations come from one
matmul and one dense solve. Residuals are pixel reprojections with Cauchy
IRLS weights; camera 0 is gauge-fixed.

The loop stays on the tensors' device: acceptance and damping are
``torch.where`` on device scalars, so no iteration syncs the host. Products
and solves run in true f32 (``_device.true_f32``), as the JAX function
forces ``default_matmul_precision("float32")``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.rotation import rotmat_to_quat, so3_hat


def bundle_adjust(
    poses: Pose,            # stacked (P, ...) w2c poses
    X: torch.Tensor,        # (N, 3)
    cam_idx: torch.Tensor,  # (M,) int
    pt_idx: torch.Tensor,   # (M,) int
    uv: torch.Tensor,       # (M, 2) index-centred pixel observations
    w_obs: torch.Tensor,    # (M,) observation weights (0 = padding)
    camera: Camera,
    iters: int = 20,
    robust_c_px: float = 2.0,
    damping: float = 1e-4,
):
    """Returns (refined poses, refined X); camera 0 is held fixed.

    LM with step acceptance: a full step is kept only if it lowers the robust
    cost, the damping then halves (floor 1e-6), else it grows 10x (ceiling
    1e5). In the acceptance cost an invisible observation (behind the camera
    or off the frame) pays the Cauchy loss of a 1e3 px residual, so a step
    that flips the model behind the cameras cannot look like a cost drop."""
    dev, dt = X.device, X.dtype
    P, N, M = poses.R.shape[0], X.shape[0], cam_idx.shape[0]
    D = 6 * (P - 1) + 3 * N
    c2 = robust_c_px**2
    cap = c2 * float(np.log1p(1e6 / c2))
    cam_idx, pt_idx = cam_idx.long(), pt_idx.long()
    camera = camera.to(dev)

    def project(poses, X):
        R_i = poses.R[cam_idx]
        p_cam = torch.einsum("mij,mj->mi", R_i, X[pt_idx]) + poses.t[cam_idx]
        uv_hat, vis = camera.project(p_cam)
        return R_i, p_cam, uv_hat, vis

    def robust_cost(poses, X):
        _, _, uv_hat, vis = project(poses, X)
        e2 = ((uv_hat - uv) ** 2).sum(-1)
        rho = c2 * torch.log1p(e2.clamp(max=1e6) / c2)
        return (w_obs * torch.where(vis, rho, cap)).sum()

    # each observation's two rows hold 6 camera and 3 point columns; camera
    # 0's block goes to camera 1's columns with zero weight (clamp), so no
    # (row, column) pair repeats and a plain scatter builds J
    rows = torch.stack([2 * torch.arange(M, device=dev), 2 * torch.arange(M, device=dev) + 1], 1)
    cc_cam = ((cam_idx - 1) * 6).clamp(min=0)[:, None] + torch.arange(6, device=dev)
    cc_pt = 6 * (P - 1) + pt_idx[:, None] * 3 + torch.arange(3, device=dev)
    cols = torch.cat([cc_cam, cc_pt], 1)                                 # (M, 9)
    flat_idx = (rows[:, :, None] * D + cols[:, None, :]).reshape(-1)     # (M * 18,)
    cam_live = (cam_idx > 0).to(dt)[:, None, None]
    eye3 = torch.eye(3, dtype=dt, device=dev).expand(M, 3, 3)
    zero6 = torch.zeros((1, 6), dtype=dt, device=dev)

    lam = torch.tensor(damping, dtype=dt, device=dev)
    with true_f32():
        for _ in range(iters):
            R_i, p_cam, uv_hat, vis = project(poses, X)
            r = uv_hat - uv
            e2 = (r * r).sum(-1)
            w = w_obs * vis.to(dt) / (1.0 + e2 / robust_c_px**2)
            sw = torch.sqrt(w)

            J_proj = camera.project_jacobian(p_cam)                       # (M, 2, 3)
            # pose block: d p_cam / d (w_rot, v) for a left delta = [-hat(p_cam) | I]
            J_pose = torch.einsum("mij,mjk->mik", J_proj, torch.cat([-so3_hat(p_cam), eye3], -1))
            J_pt = torch.einsum("mij,mjk->mik", J_proj, R_i)               # d p_cam / d X = R_i
            vals = torch.cat([J_pose * cam_live, J_pt], -1) * sw[:, None, None]   # (M, 2, 9)
            J = torch.zeros(2 * M * D, dtype=dt, device=dev).index_put_((flat_idx,), vals.reshape(-1)).view(2 * M, D)
            rflat = (r * sw[:, None]).reshape(-1)

            H = J.T @ J
            H.diagonal().add_(lam)
            g = J.T @ rflat
            delta, info = torch.linalg.solve_ex(H, -g)
            delta = torch.where(torch.isfinite(delta) & (info == 0), delta, 0.0)

            d_cam = torch.cat([zero6, delta[: 6 * (P - 1)].reshape(P - 1, 6)], 0)
            poses_new = poses.retract(d_cam)
            X_new = X + delta[6 * (P - 1):].reshape(N, 3)

            accept = robust_cost(poses_new, X_new) < robust_cost(poses, X)
            poses = poses_new.where(accept, poses)
            X = torch.where(accept, X_new, X)
            lam = torch.where(accept, (lam * 0.5).clamp(min=1e-6), (lam * 10.0).clamp(max=1e5))
    return poses, X


def bundle_adjust_scene(scene, iters: int = 20, robust_c_px: float = 2.0, max_points: int = 4000, device=None):
    """BA over a SceneModel (COLMAP's bundle_adjuster CLI role); keeps the
    ``max_points`` longest tracks when the model is larger. Returns a NEW
    SceneModel. ``device`` None is the CUDA card."""
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    dev = resolve(device)
    pids = sorted(scene.points3D)
    if len(pids) > max_points:
        pids = sorted(pids, key=lambda p: len(scene.points3D[p].image_ids), reverse=True)[:max_points]
    pid_to_row = {p: k for k, p in enumerate(pids)}
    iid_list = sorted(scene.images)
    iid_to_row = {i: k for k, i in enumerate(iid_list)}

    cam_idx, pt_idx, uvs = [], [], []
    for p in pids:
        rec = scene.points3D[p]
        for iid, kidx in zip(rec.image_ids, rec.point2D_idxs):
            cam_idx.append(iid_to_row[int(iid)])
            pt_idx.append(pid_to_row[p])
            uvs.append(scene.images[int(iid)].xys[int(kidx)] - 0.5)  # index-centred
    rows = [scene._imgidx[i] for i in iid_list]
    poses = Pose.from_quat_t(scene.qvecs[rows].astype(np.float32), scene.tvecs[rows].astype(np.float32), dev)
    X = torch.as_tensor(scene.xyz[[scene._ptidx[p] for p in pids]].astype(np.float32), device=dev)
    camera = scene.camera(scene.cameras[next(iter(scene.cameras))].camera_id, dev)
    poses2, X2 = bundle_adjust(
        poses, X,
        torch.as_tensor(np.asarray(cam_idx, np.int64), device=dev),
        torch.as_tensor(np.asarray(pt_idx, np.int64), device=dev),
        torch.as_tensor(np.asarray(uvs, np.float32).reshape(-1, 2), device=dev),
        torch.ones(len(cam_idx), device=dev), camera, iters=iters, robust_c_px=robust_c_px,
    )

    q = rotmat_to_quat(poses2.R).cpu().numpy().astype(np.float64)
    t = poses2.t.cpu().numpy().astype(np.float64)
    images = dict(scene.images)
    for k, iid in enumerate(iid_list):
        images[iid] = dataclasses.replace(images[iid], qvec=q[k], tvec=t[k])
    points = dict(scene.points3D)
    X2 = X2.cpu().numpy().astype(np.float64)
    for p in pids:
        points[p] = dataclasses.replace(points[p], xyz=X2[pid_to_row[p]])
    return SceneModel(scene.cameras, images, points)
