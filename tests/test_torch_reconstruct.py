"""The port's mapper options and its ``reconstruct`` subcommand against the
JAX package's, on the CPU, on the smallest rig of tests/test_incremental_sfm.py
(5 views of the textured cube, 17-degree steps, 144 px, rendered once by the
port and fed to both packages): ``strategy="pnp"`` (the init pair and PnP
growth), ``guided_rounds=1`` (structure-guided re-matching and the
recursive refine: the JAX package's raises, so the port's is held to the
JAX test's gates), and ``reconstruct`` through both CLIs on one folder.

JAX's RANSAC draws are replayed to the port, and JAX runs its RANSACs with
the port's one rule (samples that repeat a correspondence are not chosen),
as in tests/test_torch_incremental.py, whose ``_compare`` holds the models:
the same registered views, rotations, centres and points after a
similarity alignment to the truth, point counts.
"""

import numpy as np
import pytest
import torch

from pixtrack_tpu.mapping import incremental as jinc
from pixtrack_tpu.pipelines import cli as jcli
from pixtrack_tpu.sfm.scene import SceneModel as JScene
from pixtrack_tpu_torch.mapping import incremental as tinc
from pixtrack_tpu_torch.mapping.mesh_render import write_png
from pixtrack_tpu_torch.pipelines import cli as tcli
from pixtrack_tpu_torch.pipelines.assets import layout
from pixtrack_tpu_torch.sfm.scene import SceneModel

from test_torch_incremental import _compare, arc_views, record_jax_draws, replay_draws, run_both

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def small_arc(tmp_path_factory):
    return arc_views(tmp_path_factory.mktemp("arc5"), 5, 144, 17.0, wobble=False)


def test_mapper_pnp_strategy(small_arc):
    views, truth, jrec, trec = small_arc
    rec_j, rec_t, stats = run_both(views, jrec, trec, max_keypoints=448, nms_radius=1,
                                   match_kw=dict(min_score=0.5, ratio=0.98), strategy="pnp")
    print("draws:", stats)
    assert len(rec_t.images) >= 4
    _compare(rec_j, rec_t, truth)


def test_mapper_guided_rounds(small_arc):
    """``guided_rounds=1``: the JAX package's mapper cannot run it. Its
    recursive call passes ``seed=seed + 1`` (incremental.py:1348), but
    ``seed`` was rebound to the init pair's id list at :1018, so the call
    raises TypeError after the first pass. The port keeps the seed
    (``seed_ids`` for the list): its guided pass runs, re-matches every
    registered pair from the structure and rebuilds, and the JAX test's
    gates for this rig hold on the result; the guided matcher itself is
    held to JAX's in tests/test_torch_incremental.py."""
    views, truth, jrec, trec = small_arc
    with pytest.raises(TypeError, match="concatenate list"):
        jinc.incremental_sfm(views, jrec, max_keypoints=448, nms_radius=1, match_kw=dict(min_score=0.5, ratio=0.98),
                             guided_rounds=1)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        seeds = []
        original = tinc.incremental_sfm
        mp.setattr(tinc, "incremental_sfm", lambda *a, **kw: (seeds.append(kw.get("seed")), original(*a, **kw))[1])
        mp.setattr(tinc, "_structure_guided_matches", _counted(tinc._structure_guided_matches, calls))
        rec = original(views, trec, max_keypoints=448, nms_radius=1, match_kw=dict(min_score=0.5, ratio=0.98),
                       guided_rounds=1, device=CPU)
    assert seeds == [1] and len(calls) == 1  # one guided pass, the rebuild at seed + 1
    assert len(rec.images) >= 4 and len(rec.points3D) > 20 and np.mean(rec.point_errors) < 2.0


def _counted(fn, calls):
    def run(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    return run


def test_reconstruct_through_both_clis(small_arc, tmp_path, monkeypatch):
    views, truth, _, _ = small_arc
    src = tmp_path / "images"
    src.mkdir()
    for iid, img in views.items():
        write_png(src / f"view_{iid:04d}.png", img)
    # without KA and featuremetric BA (tests/test_torch_incremental.py runs them through the mapper)
    args = ["reconstruct", "--images", str(src), "--max_keypoints", "448", "--no-featuremetric"]
    with pytest.MonkeyPatch.context() as mp:
        draws = record_jax_draws(mp, port_rule=True)
        jcli.main(args + ["--object_path", str(tmp_path / "jax")])
    stats = {"jax": len(draws)}
    with pytest.MonkeyPatch.context() as mp:
        replay_draws(mp, draws, stats)
        tcli.main(["--device", CPU] + args + ["--object_path", str(tmp_path / "port")])
    print("draws:", stats)
    rec_j = JScene.load(layout(tmp_path / "jax")["ref_sfm"])
    rec_t = SceneModel.load(layout(tmp_path / "port")["ref_sfm"])
    assert sorted(rec_t.names) == sorted(rec_j.names) and len(rec_t.images) >= 4
    cam_j, cam_t = next(iter(rec_j.cameras.values())), next(iter(rec_t.cameras.values()))
    assert cam_t.model == cam_j.model == "SIMPLE_RADIAL"
    np.testing.assert_allclose(cam_t.params, cam_j.params, rtol=1e-6)  # f = 1.2 * 144, the centre
    _compare(rec_j, rec_t, truth)


@pytest.mark.parametrize("flags,env", [
    (["--detector", "superpoint"], {}), (["--detector", "dense"], {}), (["--matcher", "learned"], {}),
    ([], {"PIXTRACK_SUPERPOINT_WEIGHTS": "exists"}), ([], {"PIXTRACK_MATCHER_WEIGHTS": "exists"})],
    ids=["superpoint", "dense", "learned", "auto-detector-checkpoint", "auto-matcher-checkpoint"])
def test_reconstruct_refuses_the_learned_components(tmp_path, monkeypatch, flags, env):
    """The learned detectors and matcher are not ported: asked for, or
    picked by ``auto`` because a checkpoint is present, they stop the
    command before any work; never a silent Harris in their place."""
    for k in env:
        (tmp_path / "ckpt.npz").write_bytes(b"")
        monkeypatch.setenv(k, str(tmp_path / "ckpt.npz"))
    with pytest.raises(SystemExit, match="not ported"):
        tcli.main(["--device", CPU, "reconstruct", "--object_path", str(tmp_path / "obj")] + flags)
    assert not (tmp_path / "obj").exists()


def test_reconstruct_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["reconstruct", "--object_path", str(tmp_path)])
