"""The synthetic tracking world of ``tests/synthetic_world.py``, built once for
both packages, and its own parity checks.

``paired_world`` is the fixture body that the tracker-level port tests share
(variants, YCB protocol, debug trace, feature store): the JAX package's
synthetic SfM scene of the blob object written to disk in COLMAP form and
read back by the port, the same camera and ground-truth orbit in both
packages' types, a Testbed per package over the shipped distilled blob field
(``assets/bench_field.npz``; the analytic field of the JAX tests has no
counterpart in the port), query frames rendered once (by the JAX Testbed)
and shared as numpy arrays, and the mapping views written to disk as PNG.

Tolerances of the checks here: the scene's arrays exactly (one file, two
readers), reference renders within 2/255 on 99 % of the pixels (both render
the same trained field in bf16; see tests/test_torch_nerf.py).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pixtrack_tpu.geometry.nerf_transform import NerfTransform as JNerfTransform
from pixtrack_tpu.nerf.distill import load_distilled as jload_distilled
from pixtrack_tpu.nerf.testbed import Testbed as JTestbed
from pixtrack_tpu.tracking.render_bridge import render_nerf_view as jrender_nerf_view
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
from pixtrack_tpu_torch.nerf.distill import load_distilled
from pixtrack_tpu_torch.nerf.testbed import Testbed
from pixtrack_tpu_torch.sfm.scene import SceneModel
from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

from synthetic_world import gt_trajectory, make_scene

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
FIELD = REPO / "assets" / "bench_field.npz"


def _testbeds(n_coarse: int):
    jtb, ttb = JTestbed(), Testbed(device="cpu")
    jtb.set_baked_field(jload_distilled(FIELD))
    ttb.set_baked_field(load_distilled(FIELD, device="cpu"))
    for tb in (jtb, ttb):
        tb.render_aabb.min, tb.render_aabb.max = [0.3] * 3, [0.7] * 3
        tb.n_coarse, tb.n_fine = n_coarse, 0
    return jtb, ttb


def pose_error(T, T_gt):
    """(rotation degrees, translation norm) between two poses of either package."""
    dR, dt = (T @ T_gt.inv()).magnitude()
    return float(dR), float(dt)


def paired_world(tmp_dir, res: int = 96, n_frames: int = 4, n_coarse: int = 32, mapping: bool = False):
    """The world for both packages: ``.j`` and ``.t`` hold (scene, testbed,
    nerf2sfm, camera, gt); ``.frames`` the shared (name, uint8 image) list;
    ``.mapping_dir`` the mapping views on disk (with ``mapping``). A tracker
    built over it must keep ``n_coarse`` (``keep_samples``)."""
    from pixtrack_tpu.geometry import Camera as JCamera

    tmp_dir = Path(tmp_dir)
    cam_args = (res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res)
    jcam, tcam = JCamera.pinhole(*cam_args), Camera.pinhole(*cam_args)
    jscene = make_scene(jcam)
    jscene.save(tmp_dir / "sfm")
    tscene = SceneModel.load(tmp_dir / "sfm")
    jgt = gt_trajectory(n_frames)
    tgt = [Pose.from_Rt(np.asarray(T.R), np.asarray(T.t)) for T in jgt]
    jtb, ttb = _testbeds(n_coarse)
    jn2s, tn2s = JNerfTransform.identity(), NerfTransform.identity()
    frames = [(f"frame_{i:04d}.png", jrender_nerf_view(jtb, jn2s, T, jcam, spp=1)) for i, T in enumerate(jgt)]
    mapping_dir = None
    if mapping:
        import cv2

        mapping_dir = tmp_dir / "mapping"
        mapping_dir.mkdir()
        for iid in jscene.image_ids:
            img = jrender_nerf_view(jtb, jn2s, jscene.pose_w2c(iid), jcam, spp=1)
            cv2.imwrite(str(mapping_dir / jscene.images[int(iid)].name), img[..., ::-1])
    return SimpleNamespace(
        j=SimpleNamespace(scene=jscene, testbed=jtb, nerf2sfm=jn2s, camera=jcam, gt=jgt),
        t=SimpleNamespace(scene=tscene, testbed=ttb, nerf2sfm=tn2s, camera=tcam, gt=tgt),
        frames=frames, mapping_dir=None if mapping_dir is None else str(mapping_dir), n_coarse=n_coarse,
    )


def keep_samples(world, *trackers):
    """A tracker's constructor sets its Testbed to 96 samples per ray
    (``fast_render``): put the world's smaller count back."""
    for tb in (world.j.testbed, world.t.testbed):
        tb.n_coarse, tb.n_fine = world.n_coarse, 0
    return trackers


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return paired_world(tmp_path_factory.mktemp("world"), res=64, n_frames=2)


def test_scene_reads_back_equal(world):
    js, ts = world.j.scene, world.t.scene
    assert list(js.image_ids) == list(ts.image_ids) and js.names == ts.names
    for name in ("qvecs", "tvecs", "xyz"):
        np.testing.assert_array_equal(getattr(js, name), getattr(ts, name))
    assert js.covisibility_dict() == ts.covisibility_dict()
    iid = int(js.image_ids[3])
    np.testing.assert_array_equal(js.p3d_indices_for_images([iid]), ts.p3d_indices_for_images([iid]))
    np.testing.assert_allclose(np.asarray(js.pose_w2c(iid).R), ts.pose_w2c(iid).R.numpy(), atol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_render_bridge_matches(world, exact):
    """render_nerf_view of both packages at a mapping pose, with exact
    intrinsics and with the fov-derived camera: uint8 images within 2 levels
    on 99 % of the pixels, alpha within 5e-3 there."""
    iid = int(world.j.scene.image_ids[2])
    ja, jal = jrender_nerf_view(world.j.testbed, world.j.nerf2sfm, world.j.scene.pose_w2c(iid), world.j.camera,
                                spp=1, exact_intrinsics=exact, return_alpha=True)
    ta, tal = render_nerf_view(world.t.testbed, world.t.nerf2sfm, world.t.scene.pose_w2c(iid), world.t.camera,
                               spp=1, exact_intrinsics=exact, return_alpha=True)
    assert (world.t.testbed.override_intrinsics is None) == (not exact)
    assert ta.dtype == np.uint8 and ta.shape == ja.shape and ja.max() > 100
    close = np.abs(ja.astype(int) - ta.astype(int)).max(axis=-1) <= 2
    assert close.mean() >= 0.99, close.mean()
    assert (np.abs(jal - tal) <= 5e-3).mean() >= 0.99
    # the fov-derived camera is another camera than the exact one (f from the width, centre (w-1)/2)
    if not exact:
        f = world.t.testbed._intrinsics(64, 64)[0]
        assert abs(f - 64 * 1.1) < 1e-3 and world.t.testbed.fov_axis == 0
