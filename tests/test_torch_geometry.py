"""Parity of the PyTorch geometry port with the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerance: 1e-5 absolute on f32 geometry (both sides compute in f32; the
JAX package pins HIGHEST matmul precision, the port's CPU matmuls are f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.geometry import rotation as jrot
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry import rotation as trot

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(), atol=atol, rtol=0)


@pytest.fixture
def rotvecs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-6  # series branch
    return w


def test_so3_hat_exp_log(rotvecs):
    _close(jrot.so3_hat(jnp.asarray(rotvecs)), trot.so3_hat(_t(rotvecs)))
    R_j = jrot.so3_exp(jnp.asarray(rotvecs))
    R_t = trot.so3_exp(_t(rotvecs))
    _close(R_j, R_t)
    _close(jrot.so3_log(R_j), trot.so3_log(R_t), atol=1e-4)


def test_quat_and_geodesic():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    R_j = jrot.quat_to_rotmat(jnp.asarray(q))
    R_t = trot.quat_to_rotmat(_t(q))
    _close(R_j, R_t)
    # distinct rotations: at angle 0 arccos turns f32 rounding of the trace
    # into a ~5e-4 rad difference on either side
    _close(jrot.geodesic_distance(R_j[:1], R_j[1:]), trot.geodesic_distance(R_t[:1], R_t[1:]), atol=1e-4)


def test_pose_algebra():
    rng = np.random.default_rng(2)
    q, t = rng.normal(size=(2, 4)).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    delta = (0.05 * rng.normal(size=6)).astype(np.float32)
    A_j, B_j = JPose.from_quat_t(q[0], t[0]), JPose.from_quat_t(q[1], t[1])
    A_t, B_t = Pose.from_quat_t(q[0], t[0]), Pose.from_quat_t(q[1], t[1])
    for pj, pt in [
        (A_j @ B_j, A_t @ B_t),
        (A_j.inv(), A_t.inv()),
        (A_j.retract(jnp.asarray(delta)), A_t.retract(_t(delta))),
        (JPose.exp(jnp.asarray(delta)), Pose.exp(_t(delta))),
    ]:
        _close(pj.R, pt.R)
        _close(pj.t, pt.t)
    _close(A_j.transform(jnp.asarray(pts)), A_t.transform(_t(pts)))
    _close(A_j.to_4x4(), A_t.to_4x4())
    _close(A_j.center, A_t.center)
    for a, b in zip(JPose.exp(jnp.asarray(delta)).magnitude(), Pose.exp(_t(delta)).magnitude()):
        _close(a, b, atol=1e-4)


@pytest.mark.parametrize("model,params", [
    ("PINHOLE", [300.0, 310.0, 160.0, 120.0]),
    ("SIMPLE_RADIAL", [300.0, 160.0, 120.0, 0.05]),
    ("RADIAL", [300.0, 160.0, 120.0, 0.05, -0.02]),
])
def test_camera_projection(model, params):
    rng = np.random.default_rng(3)
    cj = JCamera.from_colmap(model, params, 320, 240)
    ct = Camera.from_colmap(model, params, 320, 240)
    p = rng.uniform(-0.4, 0.4, size=(64, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(0.8, 2.0, size=64)
    p[0, 2] = -1.0  # behind the camera
    p2j, vj = cj.project(jnp.asarray(p))
    p2t, vt = ct.project(_t(p))
    _close(p2j, p2t, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    _close(cj.project_jacobian(jnp.asarray(p)), ct.project_jacobian(_t(p)), atol=1e-3)
    for a, b in [(cj.scale(0.5), ct.scale(0.5)), (cj.crop([10.0, 20.0], [64.0, 48.0]), ct.crop([10.0, 20.0], [64.0, 48.0]))]:
        for name in ("size", "f", "c", "k"):
            _close(getattr(a, name), getattr(b, name))
    T = JPose.from_quat_t([1.0, 0.1, 0.0, 0.0], [0.0, 0.0, 0.2])
    Tt = Pose.from_quat_t([1.0, 0.1, 0.0, 0.0], [0.0, 0.0, 0.2])
    _close(cj.world2image(T, jnp.asarray(p))[0], ct.world2image(Tt, _t(p))[0], atol=1e-3)


def _random_rotations(n, seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(jrot.so3_exp(jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 1.5)))
    # rotations by pi about each axis and about a diagonal: the trace branch loses, the others decide
    half_turns = [np.diag(d).astype(np.float32) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
    return np.concatenate([R, np.stack(half_turns), np.eye(3, dtype=np.float32)[None]])


def test_rotmat_to_quat_matches():
    """The (w, x, y, z) order and the w >= 0 sign of the JAX function, every
    Shepperd branch taken; 1e-6."""
    R = _random_rotations(64, 5)
    qj = np.asarray(jrot.rotmat_to_quat(jnp.asarray(R)))
    qt = trot.rotmat_to_quat(_t(R))
    branches = np.argmax(np.stack([1 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], 1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
                                   1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2], 1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2]],
                                  -1), -1)
    assert set(branches.tolist()) == {0, 1, 2, 3}
    _close(qj, qt, atol=1e-6)
    assert bool((qt[:, 0] >= 0).all())
    # and back: the round trip through quat_to_rotmat
    _close(R, trot.quat_to_rotmat(qt), atol=1e-5)
    # one matrix, no batch axis
    _close(np.asarray(jrot.rotmat_to_quat(jnp.asarray(R[3]))), trot.rotmat_to_quat(_t(R[3])), atol=1e-6)


@pytest.mark.parametrize("angles,degrees", [((30.0, -20.0, 75.0), True), ((0.3, 1.2, -2.0), False), ((0.0, 0.0, 0.0), True)])
def test_euler_rotation_matches(angles, degrees):
    """Rz @ Ry @ Rx; 1e-6."""
    Rj = jrot.euler_rotation(*angles, degrees=degrees)
    Rt = trot.euler_rotation(*angles, degrees=degrees)
    assert Rt.dtype == torch.float32 and Rt.shape == (3, 3)
    _close(Rj, Rt, atol=1e-6)


def test_pose_from_4x4_and_from_aa_t_match():
    rng = np.random.default_rng(6)
    w, t = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    pj, pt = JPose.from_aa_t(w, t), Pose.from_aa_t(w, t)
    _close(pj.R, pt.R)
    _close(pj.t, pt.t)
    T = np.asarray(pj.to_4x4())
    qj, qt = JPose.from_4x4(T), Pose.from_4x4(T)
    _close(qj.R, qt.R, atol=0)
    _close(qj.t, qt.t, atol=0)
    # a tensor is taken as it is, a single matrix too
    one = Pose.from_4x4(torch.as_tensor(T[2].copy()))
    assert one.R.shape == (3, 3) and one.t.shape == (3,)
    _close(T[2, :3, 3], one.t, atol=0)
