"""The port's global initialisation (``pixtrack_tpu_torch/mapping/
global_init.py``) against the JAX package's, on the CPU.

The averaging is numpy in both packages: on tests/test_global_init.py's
synthetic ring graphs (junk edges planted, branches to select, cameras cut
off) every function is held to JAX's to 1e-9 (measured: equal bit for bit).
The pairwise relative poses run the E / H RANSACs of ``incremental.py``: on
a synthetic 8-view ring of a point cloud, JAX's draws replayed to the port
with JAX's RANSACs under the port's rule
(``test_torch_incremental.record_jax_draws``), the candidates equal in
number and support, rotations within POLISH_DEG and translations within
POLISH_T (measured 1.1e-3 deg and 5.4e-5: the 30-step Sampson polishes
end a few f32 steps apart), and ``global_initialize``'s
poses within GLOBAL_DEG and GLOBAL_T (measured 0.048 deg and 1.3e-3: the
averaging spreads the edges' gaps over the ring).
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.mapping import global_init as jgi
from pixtrack_tpu_torch.mapping import global_init as tgi

from smoke_worlds import look_at_w2c
from test_global_init import _ring_graph
from test_torch_incremental import record_jax_draws, replay_draws

torch.set_num_threads(2)
CPU = "cpu"
POLISH_DEG, POLISH_T, GLOBAL_DEG, GLOBAL_T = 0.02, 5e-4, 0.15, 5e-3


def _deg(A, B) -> float:
    """The angle between two rotations from their chord (no arccos floor)."""
    return float(np.rad2deg(2 * np.arcsin(min(np.linalg.norm(np.asarray(A, np.float64) - B) / (2 * np.sqrt(2)), 1.0))))


def _same_rels(a, b, tol=1e-9):
    assert list(a) == list(b)
    for e in a:
        assert a[e][2] == b[e][2]
        np.testing.assert_allclose(a[e][0], b[e][0], atol=tol)
        np.testing.assert_allclose(a[e][1], b[e][1], atol=tol)


@pytest.fixture(scope="module")
def junk_ring():
    rng = np.random.default_rng(0)
    ids, gt_R, centers, rels = _ring_graph(rng)
    for (a, b) in [(0, 12), (3, 15), (6, 18)]:
        rels[(a, b)] = (Rotation.random(random_state=5).as_matrix(), np.array([1.0, 0.0, 0.0]), 40)
    return ids, gt_R, centers, rels


def test_filter_edges_and_average_rotations(junk_ring):
    ids, gt_R, _, rels = junk_ring
    kept = tgi.filter_edges_by_triangles(rels, gate_deg=10.0)
    _same_rels(kept, jgi.filter_edges_by_triangles(rels, gate_deg=10.0))
    assert all(e not in kept for e in [(0, 12), (3, 15), (6, 18)])
    init = {i: gt_R[i] for i in ids[::3]}
    for kw in ({}, {"init": init}):
        Rt, Rj = tgi.average_rotations(ids, kept, **kw), jgi.average_rotations(ids, kept, **kw)
        for i in ids:
            np.testing.assert_allclose(Rt[i], Rj[i], atol=1e-9)
    D = [gt_R[i].T @ Rt[i] for i in ids]
    assert np.median([np.degrees(np.arccos(np.clip((np.trace(D[i] @ D[0].T) - 1) / 2, -1, 1))) for i in ids]) < 3.0


def test_select_branches(junk_ring):
    """Every third edge gets a second branch 20 degrees off, ranked first
    on every sixth edge: triangle consistency must pick the true one."""
    ids, _, _, rels = junk_ring
    rng = np.random.default_rng(1)
    cands = {}
    for k, (e, (R, t, w)) in enumerate(rels.items()):
        if k % 3:
            cands[e] = [(R, t, w)]
            continue
        wrong = (Rotation.from_rotvec(rng.normal(size=3) * np.deg2rad(20.0) / np.sqrt(3)).as_matrix() @ R, t, w - 5)
        cands[e] = [wrong, (R, t, w)] if k % 6 == 0 else [(R, t, w), wrong]
    sel_t, sel_j = tgi.select_branches(cands), jgi.select_branches(cands)
    _same_rels(sel_t, sel_j)
    genuine = [e for e in rels if e not in [(0, 12), (3, 15), (6, 18)]]
    assert sum(sel_t[e][0] is rels[e][0] for e in genuine) >= 0.9 * len(genuine)


def test_average_translations_and_guards():
    rng = np.random.default_rng(1)
    ids, gt_R, centers, rels = _ring_graph(rng, noise_deg=0.0)
    R = {i: gt_R[i] for i in ids}
    ct, cj = tgi.average_translations(ids, rels, R), jgi.average_translations(ids, rels, R)
    for i in ids:
        np.testing.assert_allclose(ct[i], cj[i], atol=1e-9)
    assert tgi.average_translations(ids[:2], dict(list(rels.items())[:1]), R) is None
    small = _ring_graph(np.random.default_rng(2), N=10, noise_deg=0.0)
    cut = {e: v for e, v in small[3].items() if 7 not in e}
    one_edge = {**cut, (6, 7): small[3][(6, 7)]}
    for graph in (small[3], cut, one_edge):
        assert tgi.graph_covers_all(small[0], graph) == jgi.graph_covers_all(small[0], graph)
        assert tgi.covered_component(small[0], graph) == jgi.covered_component(small[0], graph)
    assert tgi.graph_covers_all(small[0], small[3]) and not tgi.graph_covers_all(small[0], one_edge)
    Rs = [gt_R[i] for i in ids[:5]]
    np.testing.assert_allclose(tgi._quat_mean(Rs, np.arange(1.0, 6.0)), jgi._quat_mean(Rs, np.arange(1.0, 6.0)),
                               atol=1e-12)


@pytest.fixture(scope="module")
def view_ring():
    """8 cameras on a 120-degree arc around 300 points; normalised
    observations with 2e-4 noise; every pair matched by point index, with
    10 % of each pair's matches scrambled, and the two end views matched
    only 20 times (under ``min_inliers``)."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-0.35, 0.35, (300, 3))
    poses = {i: look_at_w2c(2.0 * np.array([np.sin(np.deg2rad(17.0) * i), 0.3, np.cos(np.deg2rad(17.0) * i)]))
             for i in range(1, 9)}
    kp_n = {}
    for i, T in poses.items():
        pc = T.transform(torch.as_tensor(X, dtype=torch.float32)).numpy().astype(np.float64)
        kp_n[i] = (pc[:, :2] / pc[:, 2:] + rng.normal(size=(300, 2)) * 2e-4).astype(np.float32)
    matches = {}
    for a in range(1, 9):
        for b in range(a + 1, 9):
            m = np.arange(300)
            bad = rng.choice(300, 30, replace=False)
            m[bad] = rng.permutation(m[bad])
            if (a, b) == (1, 8):
                m[20:] = -1
            matches[(a, b)] = m
    return sorted(poses), poses, kp_n, matches


def test_pairwise_relative_poses(view_ring, monkeypatch):
    ids, _, kp_n, matches = view_ring
    draws = record_jax_draws(monkeypatch, port_rule=True)
    rj = jgi.pairwise_relative_poses(ids, matches, kp_n, 500.0, jax.random.PRNGKey(0))
    left = replay_draws(monkeypatch, draws)
    rt = tgi.pairwise_relative_poses(ids, matches, kp_n, 500.0, None, device=CPU)
    assert not left
    assert list(rt) == list(rj) and (1, 8) not in rt
    pairs = [(Ra, ta, Rb, tb) for e in rj for (Ra, ta, _), (Rb, tb, _) in zip(rt[e], rj[e])]
    print("pairwise gap", max(_deg(a, c) for a, _, c, _ in pairs), max(np.abs(b - d).max() for _, b, _, d in pairs))
    for e in rj:
        assert len(rt[e]) == len(rj[e])
        for (Ra, ta, wa), (Rb, tb, wb) in zip(rt[e], rj[e]):
            assert wa == wb
            assert _deg(Ra, Rb) < POLISH_DEG and np.abs(ta - tb).max() < POLISH_T


def test_global_initialize(view_ring, monkeypatch):
    ids, poses, kp_n, matches = view_ring
    chain = {i: poses[i] for i in ids}
    draws = record_jax_draws(monkeypatch, port_rule=True)
    gj = jgi.global_initialize(ids, matches, kp_n, 500.0, jax.random.PRNGKey(2),
                               chain_init={i: JPose.from_Rt(T.R.numpy(), T.t.numpy()) for i, T in chain.items()})
    left = replay_draws(monkeypatch, draws)
    gt = tgi.global_initialize(ids, matches, kp_n, 500.0, None, chain_init=chain, device=CPU)
    assert not left
    assert sorted(gt) == sorted(gj) == ids
    print("global gap", max(_deg(gt[i].R.numpy(), np.asarray(gj[i].R)) for i in ids),
          max(np.abs(gt[i].t.numpy() - np.asarray(gj[i].t)).max() for i in ids))
    for i in ids:
        assert _deg(gt[i].R.numpy(), np.asarray(gj[i].R)) < GLOBAL_DEG
        assert np.abs(gt[i].t.numpy() - np.asarray(gj[i].t)).max() < GLOBAL_T
        # the chain init fixed the rotation gauge: the truth's
        assert float(gt[i].geodesic_to(poses[i])) < np.deg2rad(0.5)
    # a graph that cannot cover every camera keeps the chain: None
    monkeypatch.undo()
    sparse = {e: m for e, m in matches.items() if e[1] - e[0] == 1}
    assert tgi.global_initialize(ids, sparse, kp_n, 500.0, torch.Generator().manual_seed(0), chain_init=chain,
                                 device=CPU) is None


def test_global_initialize_defaults_to_the_card(view_ring, monkeypatch):
    ids, _, kp_n, matches = view_ring
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgi.global_initialize(ids, matches, kp_n, 500.0, torch.Generator().manual_seed(0))
