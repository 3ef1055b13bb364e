"""Global SfM initialisation: rotation averaging + translation averaging.

Port of ``pixtrack_tpu/mapping/global_init.py``. The chain initialiser
(``incremental._chain_initialize``) is topologically correct but
accumulates per-link error with no loop closure. Global averaging spreads
the closure over every verified pair instead: per-pair relative poses from
the E/H RANSACs of ``mapping/incremental.py`` (on the device), branch
selection and triangle filtering, robust spectral rotation averaging over
the pair graph, then camera centres from the cross-product linear system
||(c_j - c_i) x d_ij|| -> min. Everything but the per-pair RANSACs is dense
numpy on the host, as in the JAX package (the SVD is (3P x 3N), trivial at
tens to hundreds of images).

``global_initialize`` returns None, and the mapper keeps its chain init,
whenever the triangle-filtered pair graph is too sparse or does not cover
every camera in one well-connected component.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.geometry import Pose


def pairwise_relative_poses(
    ids: List[int],
    matches: Dict[Tuple[int, int], np.ndarray],
    kp_n: Dict[int, np.ndarray],
    f_mean: float,
    generator,
    min_inliers: int = 30,
    verbose: bool = False,
    device=None,
) -> Dict[Tuple[int, int], List[Tuple[np.ndarray, np.ndarray, int]]]:
    """CANDIDATE relative poses [(R_ij, t_ij unit, weight), ...] for every
    verified pair with enough matches, strongest first. Convention:
    x_cj = R_ij x_ci + t_ij (w2c chaining, R_ij = R_j R_i^T).

    Near-planar pairs (a single object face fills the overlap — the common
    case on object rigs) leave a genuine TWO-fold homography-decomposition
    ambiguity that no single pair can resolve; all near-best rotationally
    distinct branches are returned and ``select_branches`` disambiguates
    them by triangle consistency over the pair graph. The RANSACs draw
    from ``generator`` and run on ``device`` (None is the CUDA card)."""
    from pixtrack_tpu_torch.mapping.incremental import estimate_relative_pose

    dev = resolve(device)
    rels = {}
    for (a, b), m in matches.items():
        k0 = np.nonzero(m >= 0)[0]
        if len(k0) < min_inliers:
            continue
        k1 = m[k0]
        cands = estimate_relative_pose(
            kp_n[a][k0], kp_n[b][k1], generator, focal=f_mean,
            return_candidates=True, device=dev,
        )
        cands = [
            (T.R.cpu().numpy().astype(np.float64), T.t.cpu().numpy().astype(np.float64),
             int(inl.sum()))
            for (_, T, inl) in cands if int(inl.sum()) >= min_inliers
        ]
        if not cands:
            continue
        rels[(a, b)] = cands
        if verbose:
            print(f"relpose ({a},{b}): {cands[0][2]}/{len(k0)} inliers, "
                  f"{len(cands)} branch(es)")
    return rels


def select_branches(
    cand_rels: Dict[Tuple[int, int], List[Tuple[np.ndarray, np.ndarray, int]]],
    n_passes: int = 5,
    rank_penalty_deg: float = 1.0,
) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, int]]:
    """Pick one rotation branch per edge by iterated triangle consistency:
    each pass re-selects every edge's branch to minimize its best
    triangle-closure error given the current selections of its neighbors
    (small rank penalty prefers the higher-support branch on ties)."""
    from collections import defaultdict

    nbr = defaultdict(set)
    for (a, b) in cand_rels:
        nbr[a].add(b)
        nbr[b].add(a)
    sel = {e: 0 for e in cand_rels}

    def Rdir(i, j):
        if (i, j) in cand_rels:
            return cand_rels[(i, j)][sel[(i, j)]][0]
        return cand_rels[(j, i)][sel[(j, i)]][0].T

    def ang_to_I(M):
        c = (np.trace(M) - 1) / 2
        return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))

    for _ in range(n_passes):
        changed = False
        for (a, b), cands in cand_rels.items():
            if len(cands) == 1:
                continue
            commons = nbr[a] & nbr[b]
            if not commons:
                continue
            best_k, best_err = sel[(a, b)], None
            for k, (Rk, _, _) in enumerate(cands):
                err = min(
                    ang_to_I(Rdir(c, a) @ Rdir(b, c) @ Rk) for c in commons
                ) + rank_penalty_deg * k
                if best_err is None or err < best_err - 1e-9:
                    best_err, best_k = err, k
            if best_k != sel[(a, b)]:
                sel[(a, b)] = best_k
                changed = True
        if not changed:
            break
    return {e: cand_rels[e][sel[e]] for e in cand_rels}


def filter_edges_by_triangles(
    rels: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, int]],
    gate_deg: float = 10.0,
    verbose: bool = False,
) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, int]]:
    """Keep edges whose best triangle closes: for edge (a, b) and every
    common neighbor c, the 3-cycle rotation R_ca R_bc R_ab should be
    identity; an edge whose MINIMUM closure error over all its triangles
    exceeds ``gate_deg`` is inconsistent with everything around it. Edges
    with no triangles at all are also dropped (no redundancy = no evidence).
    """
    from collections import defaultdict

    nbr = defaultdict(set)
    for (a, b) in rels:
        nbr[a].add(b)
        nbr[b].add(a)

    def Rdir(i, j):
        if (i, j) in rels:
            return rels[(i, j)][0]
        return rels[(j, i)][0].T

    def ang_to_I(M):
        c = (np.trace(M) - 1) / 2
        return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))

    kept = {}
    for (a, b), v in rels.items():
        commons = nbr[a] & nbr[b]
        errs = [
            ang_to_I(Rdir(c, a) @ Rdir(b, c) @ Rdir(a, b)) for c in commons
        ]
        if errs and min(errs) <= gate_deg:
            kept[(a, b)] = v
    if verbose:
        print(f"global init: {len(kept)}/{len(rels)} edges close a triangle "
              f"(gate {gate_deg} deg)")
    return kept


def _quat_mean(Rs: List[np.ndarray], ws: np.ndarray) -> np.ndarray:
    """Weighted chordal-L2 mean of rotations via the quaternion eigenvector."""
    from scipy.spatial.transform import Rotation

    qs = Rotation.from_matrix(np.stack(Rs)).as_quat()  # (n, 4)
    qs = qs * np.sign(qs @ qs[0])[:, None]  # hemisphere-align
    M = (qs * ws[:, None]).T @ qs
    vals, vecs = np.linalg.eigh(M)
    return Rotation.from_quat(vecs[:, -1]).as_matrix()


def average_rotations(
    ids: List[int],
    rels: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, int]],
    init: Optional[Dict[int, np.ndarray]] = None,
    n_irls: int = 4,
    huber_deg: float = 10.0,
) -> Dict[int, np.ndarray]:
    """Spectral rotation averaging (chordal L2) with IRLS reweighting.

    Stack the pair graph into the symmetric 3N x 3N block matrix A with
    block (a, b) = w_ab * R_ab^T (mapping R_b-coordinates to R_a's, since
    R_a = R_ab^T R_b); the top-3 eigenvector block of A, projected to SO(3)
    per camera, is the classic one-shot global solution — no sweeps, no
    init sensitivity (local Gauss-Seidel sweeps measurably stall on ring
    graphs: closure information diffuses only one hop per sweep). A few
    IRLS rounds (Huber on per-edge angular residuals) absorb remaining
    outliers. ``init``, when given, only fixes the global gauge."""
    idx = {i: k for k, i in enumerate(ids)}
    N = len(ids)

    def ang(A_, B_):
        c = (np.trace(A_ @ B_.T) - 1) / 2
        return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))

    w_extra = {e: 1.0 for e in rels}
    R: Dict[int, np.ndarray] = {i: np.eye(3) for i in ids}
    for _ in range(n_irls):
        A = np.zeros((3 * N, 3 * N))
        for (a, b), (R_ab, _, w) in rels.items():
            ww = float(w) * w_extra[(a, b)]
            ia, ib = idx[a], idx[b]
            A[3 * ia:3 * ia + 3, 3 * ib:3 * ib + 3] += ww * R_ab.T
            A[3 * ib:3 * ib + 3, 3 * ia:3 * ia + 3] += ww * R_ab
        _, vecs = np.linalg.eigh(A)
        X = vecs[:, -3:]  # (3N, 3)
        for i in ids:
            B = X[3 * idx[i]:3 * idx[i] + 3, :]
            U, _, Vt = np.linalg.svd(B)
            R[i] = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
        changed = False
        for (a, b), (R_ab, _, _) in rels.items():
            e = ang(R_ab @ R[a], R[b])
            w_new = 1.0 if e <= huber_deg else huber_deg / e
            if abs(w_new - w_extra[(a, b)]) > 1e-3:
                changed = True
            w_extra[(a, b)] = w_new
        if not changed:
            break

    # The spectral gauge is arbitrary and RIGHT-multiplicative (w2c
    # solutions differ by a world rotation: R_i' = R_i G). Align to the init
    # by the mean of R_i^T init_i and right-multiply — estimating the gauge
    # as init_i R_i^T (left side) yields per-camera CONJUGATIONS of G whose
    # "mean" is meaningless, and left-applying it destroys the solution
    # (measured: exactly this bug turned a 1.8-deg averaged ring into an
    # 89-deg one whenever a chain init was supplied).
    if init:
        deltas = [
            R[i].T @ np.asarray(init[i], np.float64) for i in ids if i in init
        ]
        if deltas:
            G = _quat_mean(deltas, np.ones(len(deltas)))
            for i in ids:
                R[i] = R[i] @ G
    return R


def average_translations(
    ids: List[int],
    rels: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, int]],
    R: Dict[int, np.ndarray],
) -> Optional[Dict[int, np.ndarray]]:
    """Camera centers from pairwise translation directions, rotations known.

    For pair (i, j): c_j - c_i = s_ij * d_ij with d_ij = -R_j^T t_ij and
    unknown s_ij > 0; minimizing sum w ||[d_ij]_x (c_j - c_i)||^2 is linear
    in the centers. The null space is global translation (fixed by summing
    centers to zero) + global scale (the returned solution is the unit-norm
    smallest singular vector — any scale is a valid monocular gauge).
    Returns None for degenerate graphs (< 2 independent pairs)."""
    if len(rels) < 2 or len(ids) < 3:
        return None
    idx = {i: k for k, i in enumerate(ids)}
    N = len(ids)
    rows = []
    for (a, b), (R_ab, t_ab, w) in rels.items():
        d = -(R[b].T @ t_ab)
        n = np.linalg.norm(d)
        if n < 1e-9:
            continue
        d = d / n
        dx = np.array(
            [[0, -d[2], d[1]], [d[2], 0, -d[0]], [-d[1], d[0], 0]]
        )
        row = np.zeros((3, 3 * N))
        row[:, 3 * idx[b]: 3 * idx[b] + 3] = dx * np.sqrt(w)
        row[:, 3 * idx[a]: 3 * idx[a] + 3] = -dx * np.sqrt(w)
        rows.append(row)
    A = np.concatenate(rows, axis=0)
    # remove the global-translation nullspace: project onto mean-zero centers
    # by appending heavy mean constraints
    mean_rows = np.tile(np.eye(3), (1, N)) * np.sqrt(A.shape[0])
    A = np.concatenate([A, mean_rows], axis=0)
    _, s, vt = np.linalg.svd(A, full_matrices=False)
    c = vt[-1].reshape(N, 3)
    # chirality sign: the majority of pairs should have (c_j - c_i) . d > 0
    votes = 0.0
    for (a, b), (R_ab, t_ab, w) in rels.items():
        d = -(R[b].T @ t_ab)
        votes += w * np.sign(float((c[idx[b]] - c[idx[a]]) @ d))
    if votes < 0:
        c = -c
    # normalize scale: median center-to-centroid distance = 1
    c = c - c.mean(axis=0)
    scale = np.median(np.linalg.norm(c, axis=1))
    if scale < 1e-9:
        return None
    c = c / scale
    return {i: c[idx[i]] for i in ids}


def graph_covers_all(
    ids: List[int],
    rels: Dict[Tuple[int, int], Tuple],
    verbose: bool = False,
) -> bool:
    """Coverage guard for the averaging (not just edge COUNT): with total
    edges >= N but one camera isolated (weak texture -> all its edges
    triangle-filtered), the translation system's smallest singular vector is
    an exact degenerate null vector — every connected center collapses to
    one point and the isolated camera gets an arbitrary rotation (verified
    numerically: ~93%-of-radius center error on a 10-ring with one isolated
    camera). True iff every id carries >= 2 incident edges AND the pair
    graph forms a single connected component."""
    deg: Dict[int, int] = {i: 0 for i in ids}
    adj: Dict[int, set] = {i: set() for i in ids}
    for (a, b) in rels:
        deg[a] += 1
        deg[b] += 1
        adj[a].add(b)
        adj[b].add(a)
    if any(d < 2 for d in deg.values()):
        if verbose:
            weak = [i for i, d in deg.items() if d < 2]
            print(f"global init: cameras {weak} have <2 edges; "
                  "falling back to chain init")
        return False
    seen = {ids[0]}
    stack = [ids[0]]
    while stack:
        for j in adj[stack.pop()]:
            if j not in seen:
                seen.add(j)
                stack.append(j)
    if len(seen) < len(ids):
        if verbose:
            print(f"global init: pair graph disconnected "
                  f"({len(seen)}/{len(ids)} reachable); chain fallback")
        return False
    return True


def covered_component(
    ids: List[int],
    rels: Dict[Tuple[int, int], Tuple],
    verbose: bool = False,
) -> List[int]:
    """Maximal well-conditioned camera subset for averaging: iteratively
    peel cameras with < 2 incident edges (their rotation is determined by
    a single edge — no redundancy — and their center row makes the
    translation system degenerate, see graph_covers_all), then keep the
    largest connected component. Cameras outside the subset are NOT
    averaged; the caller leaves them to incremental PnP registration
    against the averaged cameras' structure — strictly better than
    discarding the whole averaging because one camera is weak."""
    alive = set(ids)
    while alive:
        deg = {i: 0 for i in alive}
        for (a, b) in rels:
            if a in alive and b in alive:
                deg[a] += 1
                deg[b] += 1
        weak = [i for i in alive if deg[i] < 2]
        if not weak:
            break
        alive -= set(weak)
    if not alive:
        return []
    adj = {i: set() for i in alive}
    for (a, b) in rels:
        if a in alive and b in alive:
            adj[a].add(b)
            adj[b].add(a)
    best: set = set()
    seen: set = set()
    for s in alive:
        if s in seen:
            continue
        comp = {s}
        stack = [s]
        while stack:
            for j in adj[stack.pop()]:
                if j not in comp:
                    comp.add(j)
                    stack.append(j)
        seen |= comp
        if len(comp) > len(best):
            best = comp
    return sorted(best)


def global_initialize(
    ids: List[int],
    matches: Dict[Tuple[int, int], np.ndarray],
    kp_n: Dict[int, np.ndarray],
    f_mean: float,
    generator,
    chain_init: Optional[Dict[int, "Pose"]] = None,
    min_inliers: int = 30,
    verbose: bool = False,
    device=None,
) -> Optional[Dict[int, "Pose"]]:
    """Full global init: pairwise poses -> rotation averaging -> translation
    averaging -> w2c Pose dict on ``device`` (None is the CUDA card).
    Returns None when the pair graph is too sparse to average (callers fall
    back to the chain)."""
    dev = resolve(device)
    cand_rels = pairwise_relative_poses(
        ids, matches, kp_n, f_mean, generator, min_inliers=min_inliers,
        verbose=verbose, device=dev,
    )
    rels = select_branches(cand_rels)

    # Edge filtering — triangle (3-cycle) consistency, BEFORE any averaging:
    # views of a small object from far-apart ring positions share almost no
    # surface, yet similar-statistics textures still yield ~30-50 "verified"
    # matches that decode to garbage rotations (measured: 180-deg edges
    # between opposite ring sides, ~95-deg wrong-H-branch edges). Filtering
    # against an averaged consensus fails chicken-and-egg (the junk edges
    # poison the consensus first); triangle closure needs no consensus —
    # a junk edge closes (almost) no triangle, a genuine one closes many.
    rels = filter_edges_by_triangles(rels, gate_deg=10.0, verbose=verbose)

    # Coverage rule (measured on the 10-view arc rig): when a chain init
    # exists, average ONLY with full coverage — a partially-covered
    # averaging (e.g. 6/10 middle cameras) plus gauge-fit extension of the
    # rest was measured WORSE than the plain chain (4.3 vs 2.9 deg global
    # median). Without a chain to fall back to, a majority subset is still
    # better than nothing; peeled cameras are left to PnP registration.
    sub = covered_component(ids, rels, verbose=verbose)
    if len(sub) < len(ids) and chain_init is not None:
        if verbose:
            print(f"global init: covered subset {len(sub)}/{len(ids)} "
                  "incomplete; falling back to chain init")
        return None
    if len(sub) < max(3, (len(ids) + 1) // 2):
        if verbose:
            print(f"global init: covered subset {len(sub)}/{len(ids)} too "
                  "small; no averaging")
        return None
    if verbose and len(sub) < len(ids):
        left = sorted(set(ids) - set(sub))
        print(f"global init: averaging {len(sub)}/{len(ids)} cameras; "
              f"{left} left to PnP registration")
    sub_set = set(sub)
    rels = {e: v for e, v in rels.items()
            if e[0] in sub_set and e[1] in sub_set}
    init_R = None
    if chain_init:
        init_R = {i: T.R.cpu().numpy().astype(np.float64)
                  for i, T in chain_init.items() if i in sub_set}

    R = average_rotations(sub, rels, init=init_R)
    centers = average_translations(sub, rels, R)
    if centers is None:
        return None
    poses = {}
    for i in sub:
        Ri = R[i].astype(np.float32)
        t = (-Ri @ centers[i]).astype(np.float32)
        poses[i] = Pose.from_Rt(Ri, t, dev)
    return poses
