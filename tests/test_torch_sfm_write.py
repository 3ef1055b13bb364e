"""The port's writers against the JAX package's, on the CPU: COLMAP models
(byte for byte), the scene container's new methods and covis.pkl, the
COLMAP database, the h5 feature stores (each package reads the other's
files), the geometry the writers need (``Camera.K``, ``fov_deg``,
``Pose.to_quat_t`` with JAX's quaternion sign), the PNG writer (cv2 reads
back the same pixels) and the procedural meshes and textures (the same
text and pixels, the shipped house included).

Tolerances: files and integer or text outputs exactly; quaternions and
other f32 geometry 1e-6.
"""

import pickle
import sqlite3
from pathlib import Path

import numpy as np
import pytest
import torch

from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.geometry.camera import CAMERA_MODEL_NUM_PARAMS as J_NUM_PARAMS
from pixtrack_tpu.mapping import procedural as jproc
from pixtrack_tpu.mapping import textures as jtex
from pixtrack_tpu.sfm import colmap_io as jcolmap
from pixtrack_tpu.sfm import database as jdb
from pixtrack_tpu.sfm import feature_store as jfs
from pixtrack_tpu.sfm.scene import SceneModel as JScene
from pixtrack_tpu_torch.geometry import CAMERA_MODEL_NUM_PARAMS, Camera, Pose
from pixtrack_tpu_torch.mapping import procedural as tproc
from pixtrack_tpu_torch.mapping import textures as ttex
from pixtrack_tpu_torch.mapping.mesh_render import load_obj, read_png, write_png
from pixtrack_tpu_torch.sfm import colmap_io as tcolmap
from pixtrack_tpu_torch.sfm import database as tdb
from pixtrack_tpu_torch.sfm import feature_store as tfs
from pixtrack_tpu_torch.sfm.scene import SceneModel

from test_sfm import make_synthetic_model

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
MW = REPO / "assets" / "mesh_world"
FILES = {".bin": ("cameras.bin", "images.bin", "points3D.bin"), ".txt": ("cameras.txt", "images.txt", "points3D.txt")}


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_writers_byte_equal(tmp_path, ext):
    cams, imgs, pts = make_synthetic_model(np.random.default_rng(0))
    jcolmap.write_model(cams, imgs, pts, tmp_path / "j", ext)
    tcolmap.write_model(cams, imgs, pts, tmp_path / "t", ext)
    for f in FILES[ext]:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    # each package reads the other's files back to the same records
    c2, i2, p2 = jcolmap.read_model(tmp_path / "t", ext)
    assert set(i2) == set(imgs) and set(p2) == set(pts)
    for iid in imgs:
        np.testing.assert_array_equal(i2[iid].xys, imgs[iid].xys)
        assert i2[iid].name == imgs[iid].name
    c3, i3, p3 = tcolmap.read_model(tmp_path / "j", ext)
    for pid in pts:
        np.testing.assert_array_equal(p3[pid].xyz, pts[pid].xyz)
        np.testing.assert_array_equal(p3[pid].image_ids, pts[pid].image_ids)


def test_shipped_model_rewritten_byte_for_byte(tmp_path):
    """The port rewrites the JAX-written aug_sfm (504 images) to the same bytes."""
    scene = SceneModel.load(MW / "aug_sfm")
    scene.save(tmp_path)
    for f in FILES[".bin"]:
        assert (tmp_path / f).read_bytes() == (MW / "aug_sfm" / f).read_bytes(), f


def test_scene_methods_match_jax(tmp_path):
    cams, imgs, pts = make_synthetic_model(np.random.default_rng(1))
    js, ts = JScene(cams, imgs, pts), SceneModel(cams, imgs, pts)
    np.testing.assert_array_equal(ts.rgb, js.rgb)
    np.testing.assert_array_equal(ts.point_errors, js.point_errors)
    assert ts._ptidx == js._ptidx
    P, JP = ts.poses_w2c(), js.poses_w2c()
    np.testing.assert_allclose(P.R.numpy(), np.asarray(JP.R), atol=1e-6)
    np.testing.assert_allclose(P.t.numpy(), np.asarray(JP.t), atol=1e-6)
    for name in ("size", "f", "c", "k"):
        np.testing.assert_array_equal(getattr(ts.camera_for_image(2), name).numpy(),
                                      np.asarray(getattr(js.camera_for_image(2), name)))
    np.testing.assert_array_equal(ts.images_for_p3d(3), js.images_for_p3d(3))
    np.testing.assert_array_equal(ts.covisibility().toarray(), js.covisibility().toarray())
    assert ts.covisibility_dict() == js.covisibility_dict()
    assert ts.covisibility_dict(threshold=5) == js.covisibility_dict(threshold=5)
    ts.save_covisibility(tmp_path / "t.pkl")
    js.save_covisibility(tmp_path / "j.pkl")
    assert (tmp_path / "t.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()
    with open(tmp_path / "t.pkl", "rb") as f:
        assert pickle.load(f) == js.covisibility_dict()
    ts.save(tmp_path / "model")
    js2 = JScene.load(tmp_path / "model")
    np.testing.assert_array_equal(js2.xyz, ts.xyz)
    assert js2.names == ts.names


def _rows(path, table):
    with sqlite3.connect(str(path)) as conn:
        return conn.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()


def test_database_matches_jax(tmp_path):
    cams, imgs, pts = make_synthetic_model(np.random.default_rng(2))
    scene = SceneModel(cams, imgs, pts)
    tdb.create_db_from_scene(scene, tmp_path / "t.db").close()
    jdb.create_db_from_scene(JScene(cams, imgs, pts), tmp_path / "j.db").close()
    for table in ("cameras", "images"):
        assert _rows(tmp_path / "t.db", table) == _rows(tmp_path / "j.db", table)
    # re-running replaces the database instead of failing on the unique ids
    tdb.create_db_from_scene(scene, tmp_path / "t.db").close()
    with jdb.ColmapDatabase(tmp_path / "t.db") as db:
        assert db.image_name_to_id() == {im.name: iid for iid, im in imgs.items()}
    # keypoints, matches and two-view geometry written by the port, read by JAX
    rng = np.random.default_rng(3)
    kp = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    m = np.stack([np.arange(20), np.arange(20) + 3], axis=1)
    with tdb.ColmapDatabase(tmp_path / "kp.db") as db:
        cid = db.add_camera(1, 640, 480, np.array([500.0, 500, 320, 240]))
        a, b = db.add_image("a.png", cid), db.add_image("b.png", cid)
        db.add_keypoints(a, kp)
        db.add_matches(b, a, m)
        db.add_two_view_geometry(a, b, m)
    with jdb.ColmapDatabase(tmp_path / "kp.db") as db:
        np.testing.assert_array_equal(db.get_keypoints(a)[:, :2], kp)
        np.testing.assert_array_equal(db.get_matches(b, a), m)
    assert tdb.image_ids_from_pair_id(tdb.pair_id_from_image_ids(7, 3)) == (3, 7)
    for table in ("keypoints", "matches", "two_view_geometries"):
        assert len(_rows(tmp_path / "kp.db", table)) == 1


def test_feature_store_cross_reads(tmp_path):
    rng = np.random.default_rng(4)
    kp = rng.uniform(0, 448, (30, 2)).astype(np.float32)
    desc = rng.normal(size=(30, 845)).astype(np.float32)
    sc = rng.uniform(size=30).astype(np.float32)
    m0 = np.full(30, -1, np.int32)
    m0[[2, 5]] = [7, 9]
    for writer, reader, tag in ((tfs, jfs, "t"), (jfs, tfs, "j")):
        f, m = tmp_path / f"{tag}_features.h5", tmp_path / f"{tag}_matches.h5"
        writer.write_features(f, "mesh_0000.png", kp, desc, sc, image_size=(448, 448))
        writer.write_matches(m, "mesh_0000.png", "mesh_0001.png", m0, sc)
        d = reader.read_features(f, "mesh_0000.png")
        np.testing.assert_array_equal(d["keypoints"], kp)
        np.testing.assert_array_equal(d["descriptors"], desc)
        np.testing.assert_array_equal(d["image_size"], [448, 448])
        assert reader.list_feature_names(f) == ["mesh_0000.png"]
        got, scores = reader.read_matches(m, "mesh_0000.png", "mesh_0001.png")
        np.testing.assert_array_equal(got, m0)
        np.testing.assert_array_equal(scores, sc)
        rev, _ = reader.read_matches(m, "mesh_0001.png", "mesh_0000.png")
        np.testing.assert_array_equal(tfs.matches_as_pairs(rev), jfs.matches_as_pairs(rev))
    assert tfs.pair_key("a/b.png", "c.png") == jfs.pair_key("a/b.png", "c.png")


def test_geometry_for_the_writers_matches_jax():
    assert CAMERA_MODEL_NUM_PARAMS == J_NUM_PARAMS
    jc, tc = JCamera.pinhole(450.0, 440.0, 223.5, 200.0, 448, 400), Camera.pinhole(450.0, 440.0, 223.5, 200.0, 448, 400)
    np.testing.assert_array_equal(tc.K().numpy(), np.asarray(jc.K()))
    for axis in (0, 1):
        np.testing.assert_allclose(float(tc.fov_deg(axis)), float(jc.fov_deg(axis)), rtol=1e-6)
    I, JI = Pose.identity((2,)), JPose.identity((2,))
    np.testing.assert_array_equal(I.R.numpy(), np.asarray(JI.R))
    np.testing.assert_array_equal(I.t.numpy(), np.asarray(JI.t))
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 3)) * np.array([[1.0], [3.0]]).repeat(32, 0)  # angles up to ~pi: w of either sign
    w[-4:] = [[np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, np.pi - 1e-3], [1e-7, 0, 0]]
    t = rng.normal(size=(64, 3))
    jp, tp = JPose.from_aa_t(w.astype(np.float32), t.astype(np.float32)), Pose.from_aa_t(w, t)
    qj, qt = np.asarray(jp.to_quat_t()[0]), tp.to_quat_t()[0].numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-6)
    assert (qt[:, 0] >= 0).all()
    a, b = Pose(tp.R[:3], tp.t[:3]), Pose(tp.R[3:6], tp.t[3:6])
    ja, jb = JPose(jp.R[:3], jp.t[:3]), JPose(jp.R[3:6], jp.t[3:6])
    c, jc2 = a.compose(b), ja.compose(jb)
    np.testing.assert_allclose(c.R.numpy(), np.asarray(jc2.R), atol=1e-6)
    np.testing.assert_allclose(c.t.numpy(), np.asarray(jc2.t), atol=1e-5)


@pytest.mark.parametrize("shape", [(37, 53, 3), (20, 31), (9, 12, 4)])
def test_png_writer_reads_back_in_cv2(tmp_path, shape):
    import cv2

    img = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png").reshape(shape), img)
    back = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED)
    if len(shape) == 3:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB if shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError):
        write_png(tmp_path / "b.png", img.astype(np.float32))


def test_shipped_house_rewritten(tmp_path):
    """make_house_obj(seed=7, size=0.3, tile=96) writes the shipped
    assets/mesh_world/src: the same OBJ and MTL text, the same atlas pixels."""
    path = tproc.make_house_obj(tmp_path, seed=7, size=0.3, tile=96)
    assert path.read_text() == (MW / "src" / "house.obj").read_text()
    assert (tmp_path / "house.mtl").read_text() == (MW / "src" / "house.mtl").read_text()
    np.testing.assert_array_equal(read_png(tmp_path / "house_tex.png"), read_png(MW / "src" / "house_tex.png"))


@pytest.mark.parametrize("name", sorted(jproc.MESH_MAKERS))
def test_procedural_meshes_match_jax(tmp_path, name):
    pj = jproc.MESH_MAKERS[name](tmp_path / "j", seed=4, size=0.3, tile=32)
    pt = tproc.MESH_MAKERS[name](tmp_path / "t", seed=4, size=0.3, tile=32)
    assert pt.read_text() == pj.read_text()
    tex = f"{name}_tex.png"
    np.testing.assert_array_equal(read_png(tmp_path / "t" / tex), read_png(tmp_path / "j" / tex))
    mesh = load_obj(pt)
    assert mesh["texture"] is not None and len(mesh["faces"]) >= 12


def test_textures_match_jax(tmp_path):
    for style in jproc.TEXTURE_STYLES:
        np.testing.assert_array_equal(tproc.procedural_texture(3, (48, 64), style),
                                      jproc.procedural_texture(3, (48, 64), style))
    aj, rj = jproc.texture_atlas(7, seed=5, tile=32)
    at, rt = tproc.texture_atlas(7, seed=5, tile=32)
    np.testing.assert_array_equal(at, aj)
    assert rt == rj
    with pytest.raises(ValueError):
        tproc.procedural_texture(0, (8, 8), "nope")
    for seed in range(4):  # the four rich families
        np.testing.assert_array_equal(ttex.rich_texture(np.random.default_rng(seed), 24, 32),
                                      jtex.rich_texture(np.random.default_rng(seed), 24, 32))
    mt = ttex.rich_cube_mesh(tmp_path / "t", seed=2, tile=16)
    mj = jtex.rich_cube_mesh(tmp_path / "j", seed=2, tile=16)
    for key in ("vertices", "uvs", "faces", "faces_uv", "texture"):
        np.testing.assert_array_equal(mt[key], mj[key])
