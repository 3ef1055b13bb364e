"""Levenberg-Marquardt feature-metric pose alignment.

Port of ``AlignConfig``, ``LevelData``, ``AlignState``,
``_residuals_and_jacobian``, ``residual_cost``, ``align_level``,
``align_level_traced`` and ``align_pyramid`` from
``pixtrack_tpu/align/lm.py``.

The JAX ``lax.while_loop`` becomes a Python loop over the same masked carry:
once ``done`` is set (or the budget is spent) an iteration changes nothing
and ``num_iters`` stops counting, so the result and the count match the JAX
loop exactly. The host reads ``done`` only every ``_CHECK_EVERY``
iterations, which keeps the loop free of a device sync per iteration.

``align_level`` and ``align_pyramid`` also take a batch of problems, as the
JAX video tracker vmaps them: poses (B,), levels whose tensors lead with B
(``p3d`` may stay (N, 3), shared), and one camera or B of them. The carry
is then per problem, (B,) ``done``, ``lam``, iteration count and best cost:
under ``vmap`` a ``while_loop`` runs while any element is active and freezes
each element's carry once that element is done, and here the masked update
does the same. One body serves both: with no batch axis the ``...`` of its
products is empty, and an unbatched call gives, to the bit, what it gave
before the batch axis came.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pixtrack_tpu_torch.align.interpolate import interpolate_features, interpolate_scalar
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.rotation import so3_hat

_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """LM configuration; the fields and defaults of the JAX AlignConfig."""

    num_iters: int = 150
    lambda_init: float = 1e-2
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-7
    lambda_max: float = 1e4
    grad_stop_criteria: float = 1e-4
    dt_stop_criteria: float = 5e-3
    dR_stop_criteria: float = 5e-4  # degrees
    robust_c: float = 0.5
    use_confidence: bool = True
    confidence_floor: float = 0.2
    eps: float = 1e-8
    stagnation_iters: int = 10
    cost_rel_tol: float = 1e-4
    min_valid_frac: float = 0.5
    level_arbitration: bool = True


@dataclasses.dataclass
class LevelData:
    """One pyramid level's observations: p3d (N, 3), f_ref (N, C), w_ref (N,),
    mask (N,) bool, fmap (H, W, C), conf (H, W) or None, scale (2,)."""

    p3d: torch.Tensor
    f_ref: torch.Tensor
    w_ref: torch.Tensor
    mask: torch.Tensor
    fmap: torch.Tensor
    conf: Optional[torch.Tensor]
    scale: torch.Tensor


@dataclasses.dataclass
class AlignState:
    T: Pose
    cost: torch.Tensor
    num_valid: torch.Tensor
    num_iters: torch.Tensor
    converged: torch.Tensor
    grad_norm: torch.Tensor


def _point_weights(e2, cq, valid, data: LevelData, cfg: AlignConfig):
    """(static weights, static x Cauchy robust weights) per point."""
    w_static = valid.float()
    if cfg.use_confidence:
        w_static = w_static * data.w_ref
        if cq is not None:
            fl = cfg.confidence_floor
            w_static = w_static * (fl + (1.0 - fl) * cq.clamp(0.0, 1.0))
    return w_static, w_static / (1.0 + e2 / cfg.robust_c**2)


def _pixel_pose_jacobian(p_cam, camera: Camera, scale):
    """d p2d_feature / d (w, v) for the left se(3) update: (..., N, 2, 6)."""
    eye = torch.eye(3, dtype=p_cam.dtype, device=p_cam.device).expand(*p_cam.shape[:-1], 3, 3)
    J_pcam = torch.cat([-so3_hat(p_cam), eye], dim=-1)
    J_proj = camera.project_jacobian(p_cam) * scale[..., None]
    return J_proj @ J_pcam


def _mean_cost(e2, w_static, valid, cfg: AlignConfig):
    """Static-weighted Cauchy cost per valid point, per problem over the
    leading axes; inf with no valid point."""
    c2 = cfg.robust_c**2
    rho = c2 * torch.log1p(e2 / c2)
    n = valid.sum(-1)
    return torch.where(n > 0, (w_static * rho).sum(-1) / n.clamp_min(1), torch.inf)


def _residuals_and_jacobian(T: Pose, data: LevelData, camera: Camera, cfg: AlignConfig,
                            compute_jac: bool = True):
    """The dense residuals and Jacobian of the JAX package's
    ``_residuals_and_jacobian``: r (..., N, C), J = d r / d (w, v) (..., N,
    C, 6) (None without compute_jac), the IRLS weights w (..., N), valid
    (..., N) and (e2, w_static). Autograd runs through all of it into
    ``data.fmap``, ``data.conf``, ``data.f_ref`` and ``data.w_ref`` (the basin
    trainer's normal equations are built from this J; ``_evaluate`` contracts
    the channel axis first, which sums in another order).

    The pose may carry batch axes: one pose per start, (P,). ``data`` may
    carry a leading scene axis (B, ...: p3d (B, N, 3), fmap (B, H, W, C),
    ...) with poses (B, P); the level's scale is shared."""
    n_scene = data.p3d.ndim - 2
    extra = T.t.ndim - 1 - n_scene

    def lift(x):  # (*S, N, ...) -> (*S, 1 per pose axis, N, ...)
        return x.reshape(*x.shape[:n_scene], *[1] * extra, *x.shape[n_scene:])

    p_cam = T.transform(lift(data.p3d))
    p2d_img, visible = camera.project(p_cam)
    p2d = p2d_img * data.scale
    f_q, grad, in_map = interpolate_features(data.fmap, p2d, compute_grad=compute_jac)
    r = f_q - lift(data.f_ref)
    valid = lift(data.mask) & visible & in_map
    e2 = (r * r).sum(-1)
    cq = None
    if cfg.use_confidence and data.conf is not None:
        cq, _ = interpolate_scalar(data.conf, p2d)
    w_static, w = _point_weights(e2, cq, valid, dataclasses.replace(data, w_ref=lift(data.w_ref)), cfg)
    if not compute_jac:
        return r, None, w, valid, (e2, w_static)
    J_pix = _pixel_pose_jacobian(p_cam, camera, data.scale)
    J = torch.einsum("...ncd,...ndk->...nck", grad, J_pix)
    return r, J, w, valid, (e2, w_static)


def _point_axis(camera: Camera) -> Camera:
    """A batch of cameras ((B, 2) fields) as (B, 1, 2): broadcast over points."""
    if camera.f.ndim < 2:
        return camera
    return Camera(size=camera.size[:, None], f=camera.f[:, None], c=camera.c[:, None], k=camera.k[:, None])


def _evaluate(T: Pose, data: LevelData, camera: Camera, cfg: AlignConfig, compute_jac: bool):
    """Cost and valid count, plus (g, H) of the normal equations with the
    channel axis contracted first (G = grad^T grad is 2x2 per point).

    For B problems (poses (B,), level tensors leading with B, the scale (2,)
    or (B, 2), one camera or B) each output leads with B: cost (B,), g (B,
    6), H (B, 6, 6), the valid counts (B,)."""
    batch = _is_batch(T, data)
    camera = _point_axis(camera)
    scale = data.scale[:, None] if data.scale.ndim == 2 else data.scale
    p_cam = T.transform(data.p3d)
    p2d_img, visible = camera.project(p_cam)
    p2d = p2d_img * scale
    f_q, grad, in_map = interpolate_features(data.fmap, p2d, compute_grad=compute_jac)
    r = f_q - data.f_ref
    valid = data.mask & visible & in_map
    e2 = (r * r).sum(-1)
    cq = None
    if cfg.use_confidence and data.conf is not None:
        cq, _ = interpolate_scalar(data.conf, p2d)
    w_static, w = _point_weights(e2, cq, valid, data, cfg)
    cost = _mean_cost(e2, w_static, valid, cfg)
    if not compute_jac:
        return cost, valid.sum(-1)
    J_pix = _pixel_pose_jacobian(p_cam, camera, scale)
    G = torch.einsum("...nca,...ncb->...nab", grad, grad)
    gr = torch.einsum("...nca,...nc->...na", grad, r)
    M = torch.einsum("...nab,...nbk->...nak", G * w[..., None, None], J_pix)
    H = torch.einsum("...nak,...nal->...kl", J_pix, M)
    g = _gradient(J_pix, gr * w[..., None]) if batch else torch.einsum("nak,na->k", J_pix, gr * w[..., None])
    return cost, g, H, valid.sum(-1)


def _gradient(J_pix, v):
    """g = sum_n J^T v of B problems, one product per problem (and one
    composition per problem in ``_retract``): the batched products sum in
    another order than the unbatched ones, and the stopping rules would then
    part a batch's problems from the same problems alone on last bits."""
    return torch.stack([torch.einsum("nak,na->k", J_pix[k], v[k]) for k in range(v.shape[0])])


def _is_batch(T: Pose, data: LevelData) -> bool:
    return T.t.ndim > 1 or data.fmap.ndim > 3


def _retract(T: Pose, delta: torch.Tensor) -> Pose:
    """``T.retract(delta)``, composed per problem in a batch."""
    if delta.ndim == 1:
        return T.retract(delta)
    E = Pose.exp(delta)
    parts = [Pose(E.R[k], E.t[k]) @ Pose(T.R[k], T.t[k]) for k in range(delta.shape[0])]
    return Pose(torch.stack([p.R for p in parts]), torch.stack([p.t for p in parts]))


def residual_cost(T: Pose, data: LevelData, camera: Camera, cfg: AlignConfig):
    """(cost, num_valid) at pose T: the accept/reject scalar and the
    tracker's adaptive threshold; (B,) each for a batch."""
    return _evaluate(T, data, camera, cfg, compute_jac=False)


def _solve(H, g, lam, cfg: AlignConfig):
    """Damped 6x6 solve by Cholesky, of one system or of a batch (B, 6, 6);
    a failed factorisation or a non-finite entry gives a zero step (JAX's
    solve returns NaN there)."""
    H_damped = H + torch.diag_embed(lam[..., None] * torch.diagonal(H, dim1=-2, dim2=-1) + cfg.eps)
    L, info = torch.linalg.cholesky_ex(H_damped)
    delta = -torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None] & torch.isfinite(delta), delta, 0.0)


def _sel(cond, a, b):
    """``torch.where`` with a per-problem ``cond`` (B,) over a's trailing axes."""
    return torch.where(cond.reshape(*cond.shape, *[1] * (a.ndim - cond.ndim)), a, b)


def align_level(T_init: Pose, data: LevelData, camera: Camera, cfg: AlignConfig) -> AlignState:
    """Deferred-accept LM on one pyramid level.

    Each iteration evaluates the current candidate once and accepts it
    against the best cost so far; a rejection re-solves from the best pose's
    (H, g) with more damping. Stops on a small gradient, a small accepted
    step, cost stagnation or the iteration budget."""
    dev = data.p3d.device
    c_best, g_best, H_best, nvalid0 = _evaluate(T_init, data, camera, cfg, True)
    batch = tuple(c_best.shape)  # () for one problem
    lam = torch.full(batch, cfg.lambda_init, dtype=torch.float32, device=dev)
    nv_floor = cfg.min_valid_frac * nvalid0.float()
    T_best = T_init
    T_cand = _retract(T_init, _solve(H_best, g_best, lam, cfg))
    i = torch.ones(batch, dtype=torch.int64, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    gnorm = torch.linalg.norm(g_best, dim=-1)
    stall = torch.zeros(batch, dtype=torch.int64, device=dev)

    for it in range(max(cfg.num_iters - 1, 0)):
        if it % _CHECK_EVERY == 0 and not bool(((i < cfg.num_iters) & ~done).any()):
            break
        active = (i < cfg.num_iters) & ~done
        c_cand, g_cand, H_cand, nv_cand = _evaluate(T_cand, data, camera, cfg, True)
        accept = (c_cand < c_best) & (nv_cand >= nv_floor)
        improved = c_cand < c_best * (1.0 - cfg.cost_rel_tol)
        T_b = T_cand.where(accept, T_best)
        c_b = torch.where(accept, c_cand, c_best)
        g_b = _sel(accept, g_cand, g_best)
        H_b = _sel(accept, H_cand, H_best)
        lam_next = torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up).clamp(
            cfg.lambda_min, cfg.lambda_max
        )
        delta = _solve(H_b, g_b, lam_next, cfg)
        T_next = _retract(T_b, delta)
        gnorm_next = torch.linalg.norm(g_b, dim=-1)
        dR, dt = Pose.exp(delta).magnitude()
        small_grad = gnorm_next < cfg.grad_stop_criteria
        small_step = accept & (dt < cfg.dt_stop_criteria) & (dR < cfg.dR_stop_criteria)
        stall_next = torch.where(improved, 0, stall + 1)
        stagnated = (stall_next >= cfg.stagnation_iters) & (cfg.stagnation_iters > 0)
        done_next = done | small_grad | small_step | stagnated

        T_best = T_b.where(active, T_best)
        c_best = torch.where(active, c_b, c_best)
        g_best = _sel(active, g_b, g_best)
        H_best = _sel(active, H_b, H_best)
        T_cand = T_next.where(active, T_cand)
        lam = torch.where(active, lam_next, lam)
        gnorm = torch.where(active, gnorm_next, gnorm)
        stall = torch.where(active, stall_next, stall)
        done = torch.where(active, done_next, done)
        i = i + active.long()

    return AlignState(
        T=T_best, cost=c_best, num_valid=nvalid0, num_iters=i, converged=done, grad_norm=gnorm,
    )


def align_level_traced(T_init: Pose, data: LevelData, camera: Camera,
                       cfg: AlignConfig) -> Tuple[AlignState, dict]:
    """LM on one level with a per-iteration trace (the DebugTracker's feed):
    the final state and ``{cost, dt, dR, accepted, active}`` tensors of length
    ``cfg.num_iters``; entries after the early stop are masked (``active``
    false, nan values).

    As in the JAX package this is the classic loop: every iteration
    evaluates the current pose, solves, and evaluates the stepped pose once
    more to accept or reject it. It stops on a small gradient or a small
    accepted step, without ``align_level``'s stagnation rule, so the two
    agree to the convergence tolerance and not to the last bit."""
    dev = data.p3d.device
    n = cfg.num_iters
    lam = torch.tensor(cfg.lambda_init, dtype=torch.float32, device=dev)
    done = torch.tensor(False, device=dev)
    _, nv0 = residual_cost(T_init, data, camera, cfg)
    nv_floor = cfg.min_valid_frac * nv0.float()
    T = T_init
    nan = torch.tensor(torch.nan, device=dev)
    trace = {k: torch.full((n,), torch.nan, device=dev) for k in ("cost", "dt", "dR")}
    trace.update({k: torch.zeros(n, dtype=torch.bool, device=dev) for k in ("accepted", "active")})
    for it in range(n):
        if it % _CHECK_EVERY == 0 and bool(done):
            break  # the remaining entries stay masked
        cost, g, H, _ = _evaluate(T, data, camera, cfg, True)
        delta = _solve(H, g, lam, cfg)
        T_new = T.retract(delta)
        new_cost, nv_new = residual_cost(T_new, data, camera, cfg)
        accept = (new_cost < cost) & (nv_new >= nv_floor) & ~done
        T = T_new.where(accept, T)
        lam_next = torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up).clamp(
            cfg.lambda_min, cfg.lambda_max
        )
        lam = torch.where(done, lam, lam_next)
        dR, dt = Pose.exp(delta).magnitude()
        small_grad = torch.linalg.norm(g) < cfg.grad_stop_criteria
        small_step = accept & (dt < cfg.dt_stop_criteria) & (dR < cfg.dR_stop_criteria)
        for k, v in (("cost", new_cost), ("dt", dt), ("dR", dR)):
            trace[k][it] = torch.where(done, nan, v)
        trace["accepted"][it] = accept
        trace["active"][it] = ~done
        done = done | small_grad | small_step
    cost_final, nvalid = residual_cost(T, data, camera, cfg)
    state = AlignState(T=T, cost=cost_final, num_valid=nvalid, num_iters=trace["active"].sum(),
                       converged=done, grad_norm=nan)
    return state, trace


def align_pyramid(
    T_init: Pose, levels: Tuple[LevelData, ...], camera: Camera, cfg: AlignConfig
) -> Tuple[AlignState, Tuple[AlignState, ...]]:
    """Coarse-to-fine over ``levels`` (given fine -> coarse). With level
    arbitration each finer level starts from whichever of the coarser
    result and the frame's init has the lower cost under its own residual,
    per problem in a batch."""
    states = []
    T = T_init
    for li, data in enumerate(reversed(levels)):
        if cfg.level_arbitration and li > 0:
            c_carry, _ = residual_cost(T, data, camera, cfg)
            c_init, _ = residual_cost(T_init, data, camera, cfg)
            T = T_init.where(c_init < c_carry, T)
        st = align_level(T, data, camera, cfg)
        T = st.T
        states.append(st)
    return states[-1], tuple(states)
