"""The port's asset stages against the JAX package's, on the CPU: the obj
pipeline's first stage ``create_scene_from_mesh`` on tests/test_mesh_render.py's
cube (160 px, ``subdiv=0``) in both packages, ``MeshTestbed`` renders, and
the four asset subcommands run end to end through
``pixtrack_tpu_torch.pipelines.cli.main`` at a cut size (96 px, twelve views,
two training steps), their files loaded by the JAX package.

Tolerances: renders, tracks and files exactly; points 1e-4 in scene units
(the f32 normal equations, as tests/test_torch_mapping.py); quaternions and
the NeRF transform 1e-6.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.geometry.nerf_transform import NerfTransform as JNerfTransform
from pixtrack_tpu.mapping import mesh_render as jmesh
from pixtrack_tpu.mapping.nerf_dataset import compute_nerf_transform as jcompute_nerf_transform
from pixtrack_tpu.nerf.snapshot import load_snapshot as jload_snapshot
from pixtrack_tpu.sfm import database as jdb
from pixtrack_tpu.sfm import feature_store as jfs
from pixtrack_tpu.sfm.scene import SceneModel as JScene
from pixtrack_tpu.tracking.render_bridge import render_nerf_view as jrender_nerf_view
from pixtrack_tpu_torch.geometry import Camera
from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
from pixtrack_tpu_torch.mapping import mesh_render as tmesh
from pixtrack_tpu_torch.pipelines import assets
from pixtrack_tpu_torch.pipelines.cli import main as cli
from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

from test_mesh_render import make_cube_obj

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
HOUSE = REPO / "assets" / "mesh_world" / "src" / "house.obj"


def test_create_scene_from_mesh_matches_jax(tmp_path):
    obj = make_cube_obj(tmp_path)
    kw = dict(image_size=160, focal=260.0, subdiv=0, max_keypoints=512)
    js, jimgs = jmesh.create_scene_from_mesh(obj, **kw)
    ts, timgs = tmesh.create_scene_from_mesh(obj, out_dir=tmp_path / "views", device="cpu", **kw)
    assert list(timgs) == list(jimgs) and len(ts.images) == 12
    for i in jimgs:
        np.testing.assert_array_equal(timgs[i], jimgs[i])
        np.testing.assert_array_equal(tmesh.read_png(tmp_path / "views" / ts.images[i].name), jimgs[i])
    assert len(ts.point_ids) == len(js.point_ids) > 10
    for pid in js.points3D:
        np.testing.assert_array_equal(ts.points3D[pid].image_ids, js.points3D[pid].image_ids)
        np.testing.assert_array_equal(ts.points3D[pid].point2D_idxs, js.points3D[pid].point2D_idxs)
    np.testing.assert_allclose(ts.xyz, js.xyz, atol=1e-4)
    np.testing.assert_allclose(ts.qvecs, js.qvecs, atol=1e-6)
    np.testing.assert_array_equal(ts.tvecs, js.tvecs)
    # tests/test_mesh_render.py's own bounds: points on the cube's surface
    m = np.abs(ts.xyz).max(axis=1)
    assert abs(np.median(m) - 0.2) < 0.03 and np.median(np.abs(m - 0.2)) < 0.06


@pytest.mark.parametrize("depth", [False, True])
def test_mesh_testbed_matches_jax(depth):
    mesh_j, mesh_t = jmesh.load_obj(HOUSE), tmesh.load_obj(HOUSE)
    T = tmesh.look_at_rig_for_mesh(mesh_t["vertices"], subdiv=0)[3]
    cam = Camera.pinhole(130.0, 130.0, 47.5, 39.5, 96, 80)
    jcam = JCamera.pinhole(130.0, 130.0, 47.5, 39.5, 96, 80)
    for exact in (True, False):
        a = jrender_nerf_view(jmesh.MeshTestbed(mesh_j), JNerfTransform.identity(),
                              JPose.from_Rt(T.R.numpy(), T.t.numpy()), jcam, spp=1, depth=depth,
                              exact_intrinsics=exact)
        b = render_nerf_view(tmesh.MeshTestbed(mesh_t), NerfTransform.identity(), T, cam, spp=1, depth=depth,
                             exact_intrinsics=exact)
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5 if depth else 0)
        assert (b > 0).mean() > 0.05


def _small_snapshot(path, paths):
    """A small hash field (4 levels, 2^12 tables) trained 40 steps on the
    capture, in place of the full-width snapshot whose bake would take
    minutes on the CPU."""
    from pixtrack_tpu_torch.mapping.nerf_dataset import estimate_aabb_from_scene
    from pixtrack_tpu_torch.nerf.dataset import NerfDataset
    from pixtrack_tpu_torch.nerf.field import init_field
    from pixtrack_tpu_torch.nerf.snapshot import save_snapshot
    from pixtrack_tpu_torch.nerf.train import TrainConfig, train
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    aabb = estimate_aabb_from_scene(SceneModel.load(paths["ref_sfm"]), NerfTransform.load(paths["nerf2sfm"]))
    field = init_field(1, device="cpu", n_levels=4, log2_table_size=12, max_res=128, hidden=32)
    ds = NerfDataset.from_transforms(paths["transforms"])
    field, _ = train(ds, aabb, TrainConfig(n_steps=40, batch_rays=512, n_coarse=16, n_fine=8, log_every=20),
                     field=field, device="cpu")
    save_snapshot(path, field, extra={"aabb": aabb})


def test_cli_asset_subcommands_end_to_end(tmp_path, monkeypatch):
    """sfm-from-obj -> train-nerf -> nerf-sfm -> augment through main([...])
    on the CPU; each stage's files load in the JAX package."""
    root = tmp_path / "house"
    paths = assets.layout(root)
    cli(["--device", "cpu", "sfm-from-obj", "--object_path", str(root), "--obj", str(HOUSE),
         "--image_size", "96", "--subdiv", "0"])
    ref = JScene.load(paths["ref_sfm"])
    assert len(ref.image_ids) == 12 and len(ref.point_ids) > 0
    assert sorted(p.name for p in paths["mapping"].glob("*.png")) == sorted(ref.names)

    with pytest.raises(ValueError, match="divide"):  # a mesh that cannot be laid out stops before training
        cli(["--device", "cpu", "train-nerf", "--object_path", str(root), "--devices", "2", "--tp", "3"])
    cli(["--device", "cpu", "train-nerf", "--object_path", str(root), "--n_steps", "2", "--batch_rays", "256",
         "--n_coarse", "8", "--n_fine", "4", "--save_every", "0"])
    tf, jtf = NerfTransform.load(paths["nerf2sfm"]), jcompute_nerf_transform(ref)
    np.testing.assert_allclose(tf.totp, jtf.totp, atol=1e-6)
    np.testing.assert_allclose(tf.scale, jtf.scale, rtol=1e-6)
    jfield, _, extra = jload_snapshot(paths["snapshot"])  # the JAX package reads the port's snapshot
    assert len(extra["aabb"]) == 2

    _small_snapshot(paths["snapshot"], paths)
    monkeypatch.setitem(sys.modules, "h5py", None)  # no h5py: asking for the h5 files raises
    with pytest.raises(RuntimeError, match="h5py"):
        cli(["--device", "cpu", "nerf-sfm", "--object_path", str(root)])
    monkeypatch.delitem(sys.modules, "h5py")
    cli(["--device", "cpu", "nerf-sfm", "--object_path", str(root), "--spp", "1"])
    nerf = JScene.load(paths["nerf_sfm"])
    assert nerf.names == ref.names
    np.testing.assert_array_equal(nerf.qvecs, ref.qvecs)
    assert len(jfs.list_feature_names(paths["features"])) == 12
    assert sorted(p.name for p in paths["nerf_sfm_mapping"].glob("*.png")) == sorted(ref.names)

    with monkeypatch.context() as m:  # the default device is the card: none here, so augment raises
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(["augment", "--object_path", str(root)])
    assert not paths["aug_sfm"].exists()
    cli(["--device", "cpu", "augment", "--object_path", str(root)])
    aug = JScene.load(paths["aug_sfm"])
    assert len(aug.image_ids) == 12 * 12 and aug.track_lengths.sum() == 12 * nerf.track_lengths.sum()
    with jdb.ColmapDatabase(paths["aug_db"]) as db:
        assert len(db.image_name_to_id()) == 144
    with open(paths["aug_sfm"] / "covis.pkl", "rb") as f:
        assert pickle.load(f) == aug.covisibility_dict()


def test_asset_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from pixtrack_tpu_torch.mapping.detector import detect_keypoints

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_keypoints(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.create_scene_from_mesh(HOUSE, image_size=32, subdiv=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["sfm-from-obj", "--object_path", str(tmp_path), "--obj", str(HOUSE), "--image_size", "32",
             "--subdiv", "0"])
