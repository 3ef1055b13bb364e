"""Parity of the port's hash-grid field, snapshots, bake, occupancy grid and
the mapping side of the asset path with the JAX package on the CPU.

Weights are carried across (``ngp_from_flax_params``), never redrawn. The
hash encoding agrees to the last bit (both packages compute the same f32
products and sum the 8 corners in one order); the field's MLPs sum in
another order, 1e-5. Snapshots, the bake's tables (hashed levels'
collisions included) and the mapping functions are exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.geometry.nerf_transform import NerfTransform as JNerfTransform
from pixtrack_tpu.mapping import mesh_render as jmesh
from pixtrack_tpu.mapping import nerf_dataset as jnd
from pixtrack_tpu.nerf import baked as jbaked
from pixtrack_tpu.nerf.dataset import NerfDataset as JNerfDataset
from pixtrack_tpu.nerf.dataset import make_synthetic_dataset as jmake_synthetic
from pixtrack_tpu.nerf.dataset import sphere_scene as jsphere
from pixtrack_tpu.nerf.field import NGPField as JNGPField
from pixtrack_tpu.nerf.field import init_field as jinit_field
from pixtrack_tpu.nerf.field import trunc_exp as jtrunc_exp
from pixtrack_tpu.nerf.snapshot import load_snapshot as jload_snapshot
from pixtrack_tpu.nerf.snapshot import save_snapshot as jsave_snapshot
from pixtrack_tpu.sfm.scene import SceneModel as JSceneModel
from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
from pixtrack_tpu_torch.mapping import mesh_render as tmesh
from pixtrack_tpu_torch.mapping import nerf_dataset as tnd
from pixtrack_tpu_torch.nerf import baked as tbaked
from pixtrack_tpu_torch.nerf.dataset import NerfDataset, make_synthetic_dataset, sphere_scene
from pixtrack_tpu_torch.nerf.field import ngp_from_flax_params, ngp_to_flax_params, trunc_exp
from pixtrack_tpu_torch.nerf.snapshot import load_snapshot, save_snapshot
from pixtrack_tpu_torch.sfm.scene import SceneModel

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
MW = REPO / "assets" / "mesh_world"
TINY = dict(n_levels=4, log2_table_size=12, base_res=4, max_res=32, hidden=16)  # tests/test_nerf.py
# all four levels cell-dense, vertex-dense (tests/test_baked.py's small_field)
DENSE = dict(n_levels=4, base_res=8, max_res=64, log2_table_size=19)


class AnalyticBlob:
    """The analytic blob (nerf.dataset.blob_scene_T) as a port field."""

    device = torch.device("cpu")

    def field_T(self, xT, dT=None):
        from pixtrack_tpu_torch.nerf.dataset import blob_scene_T

        return blob_scene_T(xT)

    def density_T(self, xT):
        return self.field_T(xT)


def pair(seed=0, scale=0.5, **cfg):
    """A JAX field and the port's with the same weights; the tables are
    redrawn in +-scale so that the encoding carries weight."""
    jf, params = jinit_field(jax.random.PRNGKey(seed), **cfg)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    enc = params["params"]["encoding"]
    for k in enc:
        enc[k] = rng.uniform(-scale, scale, enc[k].shape).astype(np.float32)
    return jf, params, ngp_from_flax_params(params, device="cpu", **cfg)


def points(n=600, seed=0):
    """Positions in [0, 1]^3 with the cube's corners 0 and 1.0 among them,
    and unit directions, feature-major."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, n)).astype(np.float32)
    x[:, :4] = 0.0
    x[:, 4:8] = 1.0
    x[0, 8:12] = 1.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=0, keepdims=True)


@pytest.mark.parametrize("cfg, dense", [(TINY, [True, True, False, False]), (DENSE, [True] * 4)],
                         ids=["tiny_dense_and_hashed", "all_dense"])
def test_hash_encoding_and_field_match_jax(cfg, dense):
    """The encoding bit for bit, dense and hashed levels, points at 0 and at
    1.0; sigma and rgb of field_T within 1e-5 (f32 sums in another order)."""
    jf, params, tf = pair(**cfg)
    assert tf.encoding.dense == dense
    x, d = points()
    enc_j = np.asarray(jf.apply(params, jnp.asarray(x), method=lambda m, v: m.encoding(v)))
    with torch.no_grad():
        enc_t = tf.encoding(torch.as_tensor(x)).numpy()
        s_t, c_t = tf.field_T(torch.as_tensor(x), torch.as_tensor(d))
    np.testing.assert_array_equal(enc_t, enc_j)
    s_j, c_j = jf.apply(params, jnp.asarray(x), jnp.asarray(d), method=JNGPField.field_T)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)


def test_dense_level_index_must_fit_the_table():
    """A dense level whose index at x = 1.0 would overrun its table is refused."""
    from pixtrack_tpu_torch.nerf.field import HashEncoding

    with pytest.raises(ValueError, match="overruns"):
        HashEncoding(n_levels=1, log2_table_size=12, base_res=15, max_res=15)  # 16^3 <= 4096 <= 16 + 16^2 + 16^3
    assert HashEncoding().dense == [True] * 5 + [False] * 11  # full width: resolutions 16-58 dense


def test_trunc_exp_gradient_beyond_the_clip():
    """exp(clip(x)) * dx everywhere: not zeroed where the clip is active."""
    x = np.asarray([-40.0, -15.0, -3.0, 0.0, 2.5, 15.0, 16.0, 100.0], np.float32)
    g_j = np.asarray(jax.vmap(jax.grad(jtrunc_exp))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    trunc_exp(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-6)
    assert xt.grad[-1] == pytest.approx(np.exp(15.0), rel=1e-6)


def test_flax_params_round_trip():
    _, params, tf = pair(**TINY)
    back = ngp_to_flax_params(tf)
    flat_a, flat_b = jax.tree_util.tree_flatten_with_path(params)[0], jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_a] == [jax.tree_util.keystr(k) for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ext", [".npz", ".msgpack"])
def test_snapshots_load_across_packages(tmp_path, ext):
    """A JAX snapshot loads into the port and a port snapshot into JAX: the
    same parameters exactly, the same keys in the same order, and the same
    outputs."""
    jf, params, tf = pair(**TINY)
    jpath, tpath = tmp_path / f"j{ext}", tmp_path / f"t{ext}"
    extra = {"aabb": [[0.1] * 3, [0.9] * 3], "steps_done": 7}
    jsave_snapshot(jpath, jf, params, extra=extra)
    save_snapshot(tpath, tf, extra=extra)
    tf2, extra2 = load_snapshot(jpath, device="cpu")
    jf2, params2, jextra2 = jload_snapshot(tpath)
    assert extra2 == extra and jextra2 == extra and jf2.n_levels == TINY["n_levels"]
    for a, b in zip(tf2.parameters(), tf.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(params2), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if ext == ".npz":
        with np.load(jpath) as zj, np.load(tpath) as zt:
            assert str(zj["__meta__"]) == str(zt["__meta__"])
    x, d = points(64)
    s_j, _ = jf2.apply(params2, jnp.asarray(x), jnp.asarray(d), method=JNGPField.field_T)
    with torch.no_grad():
        s_t, _ = tf2.field_T(torch.as_tensor(x), torch.as_tensor(d))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)


def test_bake_dense_levels_match_jax_and_the_vertex_field():
    """Cell-dense levels: the baked tables equal JAX's exactly, the baked
    field equals the port's vertex field bit for bit in its encoding, and
    JAX's baked field within 1e-5 in its outputs."""
    jf, params, tf = pair(seed=3, **DENSE)
    jb = jbaked.bake(jf, params)
    tb = tbaked.bake(tf)
    assert tb.dense == jb.dense == [True] * 4
    for a, b in zip(tb.tables, jb.tables):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x, d = points(512, seed=1)
    x = np.clip(x, 0.0, 0.999).astype(np.float32)
    with torch.no_grad():
        assert torch.equal(tb.encode_T(torch.as_tensor(x)), tf.encoding(torch.as_tensor(x)))
        s_t, c_t = tb.field_T(torch.as_tensor(x), torch.as_tensor(d))
    s_j, c_j = jb.field_T(jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)


def _hash_np(cx, cy, cz, T):
    u = np.uint32
    return ((cx.astype(u) * u(1)) ^ (cy.astype(u) * u(2654435761)) ^ (cz.astype(u) * u(805459861))) & u(T - 1)


def test_bake_hashed_level_zeros_and_collisions(monkeypatch):
    """A hashed cell level (tests/test_baked.py's forced one) filled from a
    sparse occupancy: the table equals JAX's exactly, colliding cells
    included (the last one written wins in both); slots no occupied cell
    hashes to read zero; a slot one cell owns holds that cell's corners."""
    cfg = dict(n_levels=3, base_res=8, max_res=48, log2_table_size=19)
    jf, params, tf = pair(seed=5, **cfg)
    rng = np.random.default_rng(2)
    occ = rng.uniform(size=(128, 128, 128)) < 0.03
    monkeypatch.setattr(jbaked, "occupancy_grid", lambda *a, **k: occ)
    monkeypatch.setattr(tbaked, "occupancy_grid", lambda *a, **k: occ)
    jb = jbaked.bake(jf, params, max_cell_table_log2=16)
    tb = tbaked.bake(tf, max_cell_table_log2=16)
    assert tb.dense == jb.dense == [True, True, False]
    res, Tc = int(tb.resolutions[2]), 1 << 16
    t_tab = tb.tables[2].numpy()
    np.testing.assert_array_equal(t_tab, np.asarray(jb.tables[2]))
    # the cells the bake enumerates, as the JAX package enumerates them
    ox, oy, oz = np.nonzero(occ)
    w = -(-res // 128) + 1
    sub = np.arange(w)
    sz, sy, sx = (a.ravel() for a in np.meshgrid(sub, sub, sub, indexing="ij"))
    cells = np.unique(np.stack([np.minimum((o[:, None] * res) // 128 + s[None], res - 1).ravel()
                                for o, s in ((ox, sx), (oy, sy), (oz, sz))], axis=1), axis=0)
    slots = _hash_np(cells[:, 0], cells[:, 1], cells[:, 2], Tc).astype(np.int64)
    packed = np.asarray(jbaked._pack_corners(jnp.asarray(params["params"]["encoding"]["table2"]),
                                             *(jnp.asarray(cells[:, i]) for i in range(3)), res, 1 << 19))
    owners = np.bincount(slots, minlength=Tc)
    assert (owners == 0).any() and (owners == 1).any() and (owners > 1).any()
    assert not t_tab[:, owners == 0].any()
    first = {s: i for i, s in enumerate(slots)}
    single = np.nonzero(owners == 1)[0]
    np.testing.assert_array_equal(t_tab[:, single], packed[:, [first[s] for s in single]])


def test_occupancy_grid_and_main_component_match_jax():
    """The analytic blob's occupancy (res 32, dilated once) and the main
    component of a grid with a floater added, equal in both packages."""
    from synthetic_world import _AnalyticFieldT

    occ_j = jbaked.occupancy_grid(_AnalyticFieldT(), None, res=32, sigma_threshold=0.5, dilate=1)
    occ_t = tbaked.occupancy_grid(AnalyticBlob(), res=32, sigma_threshold=0.5, dilate=1)
    np.testing.assert_array_equal(occ_t, occ_j)
    assert occ_t[16, 16, 16] and not occ_t[2, 2, 2]
    occ = occ_t.copy()
    occ[2:4, 2:4, 2:4] = True  # a floater
    main_t, main_j = tbaked.main_component(occ), jbaked.main_component(occ)
    np.testing.assert_array_equal(main_t, main_j)
    assert not main_t[2, 2, 2] and main_t[16, 16, 16]


def _write_capture(root: Path, n=3, size=(24, 20)):
    """A transforms.json capture of n PNG frames (cv2 writes them)."""
    import json

    import cv2

    rng = np.random.default_rng(4)
    (root / "images").mkdir(parents=True)
    frames = []
    for i in range(n):
        img = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / f"{i:03d}.png"), img)
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3)
        frames.append({"file_path": f"images/{i:03d}", "transform_matrix": c2w.tolist()})
    meta = {"fl_x": 30.0, "fl_y": 31.0, "cx": 12.0, "cy": 10.0, "w": size[0], "h": size[1], "aabb_scale": 2,
            "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root / "transforms.json"


@pytest.mark.parametrize("downscale", [1, 2])
def test_nerf_dataset_from_transforms_matches_jax(tmp_path, downscale):
    """Same intrinsics (the -0.5 index-centred shift), poses, and images
    within one 8-bit level (the area mean rounds as cv2.INTER_AREA does)."""
    path = _write_capture(tmp_path)
    ds_j = JNerfDataset.from_transforms(path, downscale=downscale)
    ds_t = NerfDataset.from_transforms(path, downscale=downscale)
    assert (ds_t.fx, ds_t.fy, ds_t.cx, ds_t.cy, ds_t.width, ds_t.height, ds_t.aabb_scale) == (
        ds_j.fx, ds_j.fy, ds_j.cx, ds_j.cy, ds_j.width, ds_j.height, ds_j.aabb_scale)
    np.testing.assert_array_equal(ds_t.c2w, ds_j.c2w)
    assert np.abs(ds_t.images - ds_j.images).max() <= 1.0 / 255 + 1e-6
    o_j, d_j, c_j = ds_j.all_rays()
    o_t, d_t, c_t = (a.numpy() for a in ds_t.all_rays(device="cpu"))
    np.testing.assert_allclose(o_t, o_j, atol=1e-6)
    np.testing.assert_allclose(d_t, d_j, atol=1e-6)
    np.testing.assert_allclose(c_t, c_j, atol=1.0 / 255 + 1e-6)


def test_synthetic_dataset_matches_jax():
    ds_j = jmake_synthetic(jsphere, n_views=3, res=16)
    ds_t = make_synthetic_dataset(sphere_scene, n_views=3, res=16, device="cpu")
    np.testing.assert_array_equal(ds_t.c2w, ds_j.c2w)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-5)


def test_mapping_rig_transforms_and_crop_box_match_jax(tmp_path):
    """The icosphere rig, transforms.json of the mesh world's scene under its
    nerf2sfm.pkl, and the crop box of its points."""
    np.testing.assert_array_equal(tmesh.icosphere_directions(1), jmesh.icosphere_directions(1))
    mesh = tmesh.load_obj(MW / "src" / "house.obj")
    rig_t, rig_j = tmesh.look_at_rig_for_mesh(mesh["vertices"]), jmesh.look_at_rig_for_mesh(mesh["vertices"])
    assert len(rig_t) == len(rig_j) == 42
    for a, b in zip(rig_t, rig_j):
        np.testing.assert_array_equal(a.R.numpy(), np.asarray(b.R))
        np.testing.assert_array_equal(a.t.numpy(), np.asarray(b.t))
    scene_t, scene_j = SceneModel.load(MW / "aug_sfm"), JSceneModel.load(MW / "aug_sfm")
    n2s_t, n2s_j = NerfTransform.load(MW / "nerf2sfm.pkl"), JNerfTransform.load(MW / "nerf2sfm.pkl")
    meta_t = tnd.write_transforms_json(scene_t, n2s_t, tmp_path / "t" / "transforms.json")
    meta_j = jnd.write_transforms_json(scene_j, n2s_j, tmp_path / "j" / "transforms.json")
    assert {k: v for k, v in meta_t.items() if k != "frames"} == {k: v for k, v in meta_j.items() if k != "frames"}
    for a, b in zip(meta_t["frames"], meta_j["frames"]):
        assert a["file_path"] == b["file_path"]
        # the f32 rotations from quaternions differ in the last bit (2e-7), scaled by the normalisation
        np.testing.assert_allclose(a["transform_matrix"], b["transform_matrix"], atol=1e-5)
    box_t, box_j = tnd.estimate_aabb_from_scene(scene_t, n2s_t), jnd.estimate_aabb_from_scene(scene_j, n2s_j)
    np.testing.assert_allclose(box_t, box_j, rtol=0, atol=1e-12)


def test_transforms_from_yaml_matches_jax(tmp_path):
    """The normalisation derived from a YAML rig (the mapping rig's first 12
    views, upright, so the summed up vector is well conditioned; on the
    roll-augmented aug_sfm images it nearly cancels and f32 rounding of the
    poses moves it by 3e-3) and the transforms.json written from it."""
    import yaml

    rig = jmesh.look_at_rig_for_mesh(tmesh.load_obj(MW / "src" / "house.obj")["vertices"])[:12]
    info = {"camera": {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0, "cx": 32.0, "cy": 24.0},
            "frames": [{"file_path": f"mapping/{i:04d}.png", "c2w": np.linalg.inv(np.asarray(T.to_4x4())).tolist()}
                       for i, T in enumerate(rig)]}
    (tmp_path / "scene.yaml").write_text(yaml.safe_dump(info))
    meta_t = tnd.transforms_from_yaml(tmp_path / "scene.yaml", tmp_path / "t" / "transforms.json")
    meta_j = jnd.transforms_from_yaml(tmp_path / "scene.yaml", tmp_path / "j" / "transforms.json")
    for a, b in zip(meta_t["frames"], meta_j["frames"]):
        np.testing.assert_allclose(a["transform_matrix"], b["transform_matrix"], atol=1e-5)
    n2s_t = NerfTransform.load(tmp_path / "t" / "nerf2sfm.pkl")
    n2s_j = JNerfTransform.load(tmp_path / "j" / "nerf2sfm.pkl")
    for k in ("centroid", "avglen", "R", "totp", "up"):
        np.testing.assert_allclose(getattr(n2s_t, k), getattr(n2s_j, k), rtol=1e-5, atol=1e-6)
