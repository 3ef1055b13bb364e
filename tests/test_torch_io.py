"""The port's host-side IO against the JAX package and the test helpers:
the SfM scene, the PNG reader, OBJ loading, the mesh rasteriser, surface
sampling and the blob world's geometry (exact, or 1e-6 where both sides
compute in f32) — and a check that the port never imports JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pixtrack_tpu_torch.geometry import Camera, Pose

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
MW = REPO / "assets" / "mesh_world"


def test_scene_load_matches_jax():
    from pixtrack_tpu.sfm.scene import SceneModel as JScene
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    js, ts = JScene.load(MW / "aug_sfm"), SceneModel.load(MW / "aug_sfm")
    np.testing.assert_array_equal(js.image_ids, ts.image_ids)
    np.testing.assert_array_equal(js.qvecs, ts.qvecs)
    np.testing.assert_array_equal(js.xyz, ts.xyz)
    assert js.names == ts.names
    ids = [int(i) for i in js.image_ids[[0, 7, 100]]]
    for i in ids:
        np.testing.assert_allclose(np.asarray(js.pose_w2c(i).R), ts.pose_w2c(i).R.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(js.pose_w2c(i).t), ts.pose_w2c(i).t.numpy(), atol=1e-6)
    jc, tc = js.camera(1), ts.camera(1)
    for name in ("size", "f", "c", "k"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)), getattr(tc, name).numpy())
    idx = js.p3d_indices_for_images(ids)
    np.testing.assert_array_equal(idx, ts.p3d_indices_for_images(ids))
    for a, b in zip(js.pack_points(idx, pad_multiple=1024), ts.pack_points(idx, pad_multiple=1024)):
        np.testing.assert_array_equal(a, b)
    assert js.covisibility_dict() == ts.covisibility_dict()


def test_png_reader_matches_cv2():
    import cv2

    from pixtrack_tpu_torch.mapping.mesh_render import read_png

    path = MW / "src" / "house_tex.png"
    ref = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_png(path), ref)


def test_png_reader_all_filters(tmp_path):
    """Rows written with every PNG filter type decode exactly (cv2 writes them)."""
    import cv2

    from pixtrack_tpu_torch.mapping.mesh_render import read_png

    img = (np.random.default_rng(0).uniform(0, 255, (23, 17, 3))).astype(np.uint8)
    img[:, :5] = 40  # flat runs and gradients exercise the predictors
    img[5:9] = np.arange(17, dtype=np.uint8)[None, :, None] * 9
    path = tmp_path / "t.png"
    cv2.imwrite(str(path), img[..., ::-1], [cv2.IMWRITE_PNG_STRATEGY, cv2.IMWRITE_PNG_STRATEGY_FILTERED])
    np.testing.assert_array_equal(read_png(path), img)


def test_obj_render_and_sampling_match_jax():
    from pixtrack_tpu.geometry import Camera as JCamera
    from pixtrack_tpu.geometry import Pose as JPose
    from pixtrack_tpu.mapping.mesh_render import load_obj as jload_obj
    from pixtrack_tpu.mapping.mesh_render import render_mesh as jrender_mesh
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh, sample_mesh_surface

    sys.path.insert(0, str(REPO / "tests"))
    from mesh_world import sample_mesh_surface as jsample
    from synthetic_world import look_at_w2c as jlook_at

    jm, tm = jload_obj(MW / "src" / "house.obj"), load_obj(MW / "src" / "house.obj")
    for key in ("vertices", "uvs", "faces", "faces_uv", "texture"):
        np.testing.assert_array_equal(jm[key], tm[key])
    np.testing.assert_array_equal(jsample(jm, 512, seed=3), sample_mesh_surface(tm, 512, seed=3))

    center = jm["vertices"].mean(axis=0)
    eye = center + np.array([0.25, 0.2, 0.6])
    Tj = jlook_at(eye, target=center)
    Tt = Pose.from_Rt(np.asarray(Tj.R), np.asarray(Tj.t))
    cam = (150.0, 150.0, 79.5, 59.5, 160, 120)
    ij, dj = jrender_mesh(jm, Tj, JCamera.pinhole(*cam), background=(0.0, 0.0, 0.0), return_depth=True)
    it, dt = render_mesh(tm, Tt, Camera.pinhole(*cam), background=(0.0, 0.0, 0.0), return_depth=True)
    assert (dt > 0).mean() > 0.1  # the house is in view
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_allclose(dj, dt, atol=1e-6)


def test_blob_world_geometry_matches_test_helpers():
    sys.path.insert(0, str(REPO / "tests"))
    from synthetic_world import look_at_w2c as jlook_at
    from synthetic_world import sphere_surface_points as jsphere

    from smoke_worlds import look_at_w2c, sphere_surface_points

    np.testing.assert_array_equal(jsphere(n=4200, seed=0), sphere_surface_points(n=4200))
    c = np.array([0.3, 0.5, 1.5])
    Tj, Tt = jlook_at(c), look_at_w2c(c)
    np.testing.assert_array_equal(np.asarray(Tj.R), Tt.R.numpy())
    np.testing.assert_array_equal(np.asarray(Tj.t), Tt.t.numpy())


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the entry points ask for the CUDA card and,
    without one, raise instead of falling back to the CPU; device="cpu" runs there."""
    from pixtrack_tpu_torch.features import default_extractor
    from pixtrack_tpu_torch.features.unet import load_unet_weights
    from pixtrack_tpu_torch.nerf.distill import init_distilled, load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    field, unet = MW / "field.npz", REPO / "assets" / "unet_basin.npz"
    calls = [Testbed, lambda **kw: load_distilled(field, **kw), default_extractor,
             lambda **kw: init_distilled(0, **kw), lambda **kw: load_unet_weights(unet, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert Testbed(device="cpu").device.type == "cpu"
    assert load_distilled(field, device="cpu").device.type == "cpu"
    assert default_extractor(device="cpu").device.type == "cpu"


_NO_JAX_CHECK = """
import builtins, importlib, pkgutil, runpy, sys
from pathlib import Path
jax_pkg = (Path.cwd() / "pixtrack_tpu").resolve()
def under_jax_pkg(m):
    f = getattr(m, "__file__", None)
    return f is not None and Path(f).resolve().is_relative_to(jax_pkg)
def bad():
    names = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pixtrack_tpu")]
    return names + [k for k, m in list(sys.modules.items()) if under_jax_pkg(m)]
# chip_smoke.py and smoke_worlds.py import or load nothing of the JAX package
runpy.run_path("smoke_worlds.py")
mod = runpy.run_path("chip_smoke.py", run_name="chip_smoke")
import smoke_worlds
assert not bad(), bad()
import pixtrack_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, "pixtrack_tpu_torch.")]
for m in mods: importlib.import_module(m)
assert not bad(), bad()
print(len(mods))
"""


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and smoke_worlds.py import
    without JAX, flax, tqdm or any file of the JAX package."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX_CHECK], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30
    # torch itself may load tqdm; no module of the port imports it, nor the two scripts
    srcs = list((REPO / "pixtrack_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "smoke_worlds.py"]
    for src in srcs:
        for line in src.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "flax", "tqdm", "pixtrack_tpu"), (src, line)


_EACH_FIRST = """
import importlib, pkgutil, sys
import pixtrack_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, "pixtrack_tpu_torch.")]
for name in mods:
    for k in [k for k in sys.modules if k.split(".")[0] == "pixtrack_tpu_torch"]:
        del sys.modules[k]
    importlib.import_module(name)
print(len(mods))
"""


def test_each_port_module_imports_first():
    """Every module of the port imports as the first of the package that an
    interpreter loads, as a spawned worker imports the module of its job
    (no import cycle)."""
    out = subprocess.run([sys.executable, "-c", _EACH_FIRST], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pixtrack_tpu", "tests")
_LAZY_ONLY = ("cv2", "h5py", "yaml", "PIL", "imageio", "matplotlib", "tqdm", "msgpack")


def _imports(tree):
    """(top-level name, is at module level) of every import in a parsed file."""
    import ast

    top_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top_level


def test_import_guard():
    """No file of the port, nor chip_smoke.py, smoke_worlds.py,
    scripts_dev/asset_build_full.py or scripts_dev/train_basin_card.py (all
    run on the card's machine), imports
    JAX, flax, optax, the JAX package or the tests, anywhere; and the optional
    host libraries (cv2, h5py, yaml, PIL, imageio, matplotlib, tqdm, msgpack)
    are imported inside functions only, never when a module is imported."""
    import ast

    srcs = sorted((REPO / "pixtrack_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "smoke_worlds.py", REPO / "scripts_dev" / "asset_build_full.py",
        REPO / "scripts_dev" / "train_basin_card.py"]
    assert len(srcs) >= 80
    # the learned SfM components, the demo's world and the image conversion are in the walk
    for mod in ("mapping/dense_descriptor.py", "mapping/superpoint.py", "mapping/attention_matcher.py",
                "mapping/train_matcher.py", "pipelines/demo_world.py", "utils/image_convert.py",
                "parallel/video.py", "parallel/mesh.py"):
        assert REPO / "pixtrack_tpu_torch" / mod in srcs, mod
    seen_lazy = set()
    for src in srcs:
        for name, at_module_level in _imports(ast.parse(src.read_text(), filename=str(src))):
            assert name not in _FORBIDDEN, f"{src.relative_to(REPO)} imports {name}"
            if name in _LAZY_ONLY:
                assert not at_module_level, f"{src.relative_to(REPO)} imports {name} at module level"
                seen_lazy.add(name)
    assert {"cv2", "h5py", "yaml", "msgpack", "PIL"} <= seen_lazy  # the walk does see the imports inside functions
    # the check itself: a top-level import is told from one inside a function
    probe = ast.parse("import cv2\ndef f():\n    import h5py\n    from jax import numpy\n")
    assert sorted(_imports(probe)) == [("cv2", True), ("h5py", False), ("jax", False)]


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The entry points of the tracking side added last (handcrafted
    extractor, feature store, YCB iterator, run configuration) ask for the
    CUDA card unless a device is named."""
    from pixtrack_tpu_torch.features import HandcraftedExtractor
    from pixtrack_tpu_torch.tracking.feature_io import load_reference_features
    from pixtrack_tpu_torch.utils.config import RunConfig
    from pixtrack_tpu_torch.utils.io import YCBVideoIterator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PIXTRACK_UNET_WEIGHTS", str(tmp_path / "missing.npz"))
    from pixtrack_tpu_torch.features import default_extractor

    calls = [HandcraftedExtractor, default_extractor, lambda: load_reference_features(tmp_path / "none.h5"),
             lambda: YCBVideoIterator(tmp_path, "1", 5), RunConfig().make_extractor,
             RunConfig(extractor="handcrafted").make_extractor]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert HandcraftedExtractor(device="cpu").device.type == "cpu"
