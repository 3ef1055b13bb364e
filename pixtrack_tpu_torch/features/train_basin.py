"""Basin-aware UNet feature training: differentiate through the aligner.

Port of ``pixtrack_tpu/features/train_basin.py``, the recipe behind
``assets/unet_basin.npz``. Each scene is a textured plane rendered with
exact perspective: a clean reference view at a pose a few degrees off the
query's (what the tracker renders at its previous estimate) and a query
view over background clutter with photometric jitter, blur, noise and
occluders. K damped Gauss-Newton steps a level, coarse to fine, run from
sampled pose perturbations through the production residuals
(``align.lm._residuals_and_jacobian``: the same interpolation, masks,
confidences and robust weights as inference), and the loss is the clamped
reprojection error of the scene's points after every step. Autograd carries
it through the 6x6 solves, the bilinear feature and confidence sampling and
the observation into the UNet.

Where the JAX package vmaps ``one_scene`` over the batch and each scene's
unrolled align over its perturbations, the port carries both as batch axes:
the scenes' maps and points (B, ...) and the starts' poses (B, P), so one
Gauss-Newton step is one pass of batched kernels for all B x P starts. On
the card a training step (loss, backward, clip) is one CUDA graph replay.
Draws are dicts of canonical draws from a ``torch.Generator``
(``features/train.py``). Two of the reference's draws reuse a key, and the
port keeps both: a texture's frequency signs are ``u < 0.5`` of the same
uniform that sets its magnitudes (every mode below sqrt(0.5 * 40) *
freq_scale cycles is negative), and the first entry of the query noise is
the normal that jax.random.normal makes of the noise amplitude's uniform.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch._draws import _normal_of_uniform, _rand, _randn, _uniform
from pixtrack_tpu_torch.align.interpolate import interpolate_features
from pixtrack_tpu_torch.align.lm import AlignConfig, LevelData, _residuals_and_jacobian
from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
from pixtrack_tpu_torch.features.pyramid import FeaturePyramid
from pixtrack_tpu_torch.features.train import _grid
from pixtrack_tpu_torch.features.unet import UNetExtractor, init_unet, normalize_features
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.nerf.optim import Adam, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class BasinTrainConfig:
    """The JAX package's fields and defaults. ``scan_steps`` is accepted and
    changes nothing: it chose between ``lax.scan`` and an unrolled loop for
    XLA's compile time, and the port's loop over the GN steps is the same
    loop either way."""

    n_steps: int = 3000
    batch: int = 2              # scenes per step
    n_perturb: int = 4          # pose perturbations per scene
    size: int = 192             # render size (multiple of 16)
    tex_size: int = 256
    n_points: int = 512         # 3D points on the plane
    k_steps: int = 5            # unrolled GN steps per level
    lam: float = 3e-2           # fixed GN damping during training
    lr: float = 1e-3
    rot_deg: Tuple[float, float] = (1.0, 10.0)
    trans_frac: Tuple[float, float] = (0.005, 0.05)   # x camera distance
    ref_rot_deg: float = 3.0
    max_blur_sigma: float = 1.5
    max_noise: float = 0.04
    n_occluders: int = 2
    max_occluder_frac: float = 0.3
    reproj_clip_px: float = 12.0
    scan_steps: bool = True
    log_every: int = 100


# ------------------------------------------------------------------ draws ---
def texture_draws(lead: tuple, n_modes: int = 48, generator=None, device=None) -> dict:
    return {"freqs": _rand(generator, device, *lead, 3, n_modes, 2),
            "amps": _randn(generator, device, *lead, 3, n_modes),
            "phases": _rand(generator, device, *lead, 3, n_modes)}


def nuisance_draws(lead: tuple, size: int, n_occluders: int, generator=None, device=None) -> dict:
    """``apply_nuisances``' draws; the noise field's first entry is the
    normal of the amplitude's uniform (the reference draws both from one key)."""
    amp = _rand(generator, device, *lead)
    noise = _randn(generator, device, *lead, size, size, 3)
    noise[..., 0, 0, 0] = _normal_of_uniform(amp)
    return {"gain": _randn(generator, device, *lead, 3), "bias": _randn(generator, device, *lead, 3),
            "gamma": _randn(generator, device, *lead), "sigma": _rand(generator, device, *lead),
            "noise_amp": amp, "noise": noise,
            "occ_pos": _rand(generator, device, *lead, n_occluders, 2),
            "occ_size": _rand(generator, device, *lead, n_occluders, 2)}


def perturbation_draws(lead: tuple, n_perturb: int, generator=None, device=None) -> dict:
    return {"w": _randn(generator, device, *lead, n_perturb, 3), "v": _randn(generator, device, *lead, n_perturb, 3),
            "m": _rand(generator, device, *lead, n_perturb, 2)}


def scene_draws(cfg: BasinTrainConfig, generator=None, device=None) -> dict:
    """One training step's draws for ``cfg.batch`` scenes."""
    lead = (cfg.batch,)
    ints = lambda hi: torch.randint(0, hi, lead, generator=generator, device=device)  # noqa: E731
    return {"texture": texture_draws(lead, 48, generator, device),
            "clutter": texture_draws(lead, 48, generator, device),
            "smooth": _rand(generator, device, *lead),
            "pose": _rand(generator, device, *lead, 3),     # distance, polar, azimuth
            "roll": _rand(generator, device, *lead),
            "ref": _randn(generator, device, *lead, 6),
            "points": _rand(generator, device, *lead, cfg.n_points, 2),
            "nuisance": nuisance_draws(lead, cfg.size, cfg.n_occluders, generator, device),
            "perturb": perturbation_draws(lead, cfg.n_perturb, generator, device),
            "qbg": ints(4), "rbg": ints(2)}


# ------------------------------------------------------------ scene render ---
def _look_at_w2c(center: torch.Tensor, roll: torch.Tensor) -> Pose:
    """w2c pose looking from ``center`` (..., 3) at the origin, +Z forward,
    rolled by ``roll`` (...) in the image plane."""
    z = -center / torch.linalg.norm(center, dim=-1, keepdim=True).clamp_min(1e-8)
    eye = torch.eye(3, dtype=z.dtype, device=z.device)
    up = torch.where((z[..., 1].abs() > 0.95)[..., None], eye[0], eye[1])
    x = torch.linalg.cross(z, up)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)
    y = torch.linalg.cross(z, x)
    R_cam = torch.stack([x, y, z], dim=-2)
    c, s = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R_roll = torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                          torch.stack([zero, zero, one], -1)], -2)
    R = R_roll @ R_cam
    return Pose(R=R, t=-(R @ center[..., None])[..., 0])


def render_plane(texture: torch.Tensor, background: Optional[torch.Tensor], T_w2c: Pose, camera: Camera,
                 size: Tuple[int, int]) -> torch.Tensor:
    """Exact perspective render of the textured plane Z = 0, [-0.5, 0.5]^2,
    over ``background`` (screen-space, (H, W, 3)) or white (None). Batched
    over a leading scene axis of texture, background and pose alike."""
    H, W = size
    dev = texture.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=texture.dtype, device=dev),
                            torch.arange(W, dtype=texture.dtype, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)
    d_cam = torch.cat([(pix - camera.c) / camera.f, torch.ones_like(pix[:, :1])], dim=1)
    R, t = T_w2c.R, T_w2c.t
    d_w = d_cam @ R
    o_w = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    den = torch.where(d_w[..., 2].abs() < 1e-8, 1e-8, d_w[..., 2])
    s = -o_w[..., None, 2] / den
    uv = o_w[..., None, :2] + s[..., None] * d_w[..., :2]
    hit = (s > 1e-3) & (uv[..., 0].abs() <= 0.5) & (uv[..., 1].abs() <= 0.5)
    S = texture.shape[-3]
    vals, _, _ = interpolate_features(texture, (uv + 0.5) * (S - 1), compute_grad=False)
    if background is None:
        bg = torch.ones_like(vals)
    else:
        bg = background.reshape(vals.shape)
    return torch.where(hit[..., None], vals, bg).reshape(*vals.shape[:-2], H, W, 3)


def random_texture(size: int, n_modes: int = 48, freq_scale=1.0, generator=None, device=None,
                   draws: Optional[dict] = None) -> torch.Tensor:
    """Random RGB texture (..., size, size, 3) mixing low and high spatial
    frequencies; ``freq_scale`` (a float or a tensor over the draws' batch
    shape) shifts the spectrum down."""
    device = resolve(device)
    d = draws or texture_draws((), n_modes, generator, device)
    lead = d["amps"].shape[:-2]
    n_modes = d["amps"].shape[-1]
    fs = freq_scale.reshape(*freq_scale.shape, 1, 1, 1) if torch.is_tensor(freq_scale) else float(freq_scale)
    sign = torch.where(d["freqs"] < 0.5, -1.0, 1.0)
    freqs = fs * torch.exp(_uniform(d["freqs"], np.log(0.5), np.log(40.0))) * sign
    amps = d["amps"] / np.sqrt(n_modes)
    amps = amps / torch.sqrt(torch.linalg.norm(freqs, dim=-1).clamp_min(1.0))
    phases = _uniform(d["phases"], 0.0, 2 * np.pi)
    phase = torch.einsum("...cmk,pk->...cmp", freqs, _grid(size, device)) * 2 * np.pi + phases[..., None]
    img = torch.einsum("...cm,...cmp->...cp", amps, torch.sin(phase))
    return torch.sigmoid(3.0 * img.reshape(*lead, 3, size, size).movedim(-3, -1))


def _blur_traced(img: torch.Tensor, sigma: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W, C) with a per-image sigma (...),
    edges replicated; one depthwise convolution per axis."""
    *lead, H, W, C = img.shape
    nb = int(np.prod(lead)) if lead else 1
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    sig = torch.as_tensor(sigma, dtype=img.dtype, device=img.device).reshape(nb, 1).clamp_min(0.25)
    k = torch.exp(-0.5 * (x / sig) ** 2)
    k = (k / k.sum(-1, keepdim=True)).repeat_interleave(C, 0)
    xb = img.reshape(nb, H, W, C).permute(0, 3, 1, 2).reshape(1, nb * C, H, W)
    xb = F.pad(xb, (radius, radius, radius, radius), mode="replicate")
    xb = F.conv2d(xb, k[:, None, :, None], groups=nb * C)
    xb = F.conv2d(xb, k[:, None, None, :], groups=nb * C)
    return xb.reshape(nb, C, H, W).permute(0, 2, 3, 1).reshape(img.shape)


def apply_nuisances(img: torch.Tensor, clutter: torch.Tensor, cfg: BasinTrainConfig, generator=None,
                    draws: Optional[dict] = None) -> torch.Tensor:
    """Photometric jitter, blur, noise and rectangular occluders filled with
    the rolled clutter texture (the query's nuisances), over (..., H, W, 3)."""
    *lead, H, W, _ = img.shape
    d = draws or nuisance_draws(tuple(lead), H, cfg.n_occluders, generator, img.device)
    gain = 1.0 + 0.25 * d["gain"]
    bias = 0.1 * d["bias"]
    gamma = torch.exp(0.25 * d["gamma"])
    out = img.clamp(1e-4, 1.0) ** gamma[..., None, None, None]
    out = out * gain[..., None, None, :] + bias[..., None, None, :]
    out = _blur_traced(out, _uniform(d["sigma"], 0.0, cfg.max_blur_sigma))
    out = out + _uniform(d["noise_amp"], 0.0, cfg.max_noise)[..., None, None, None] * d["noise"]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=img.dtype, device=img.device),
                            torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    for i in range(cfg.n_occluders):
        cx = _uniform(d["occ_pos"][..., i, :], 0.0, 1.0)[..., None, None, :]
        wh = _uniform(d["occ_size"][..., i, :], 0.05, cfg.max_occluder_frac)[..., None, None, :]
        inside = ((xs / W - cx[..., 0]).abs() < wh[..., 0] / 2) & ((ys / H - cx[..., 1]).abs() < wh[..., 1] / 2)
        out = torch.where(inside[..., None], torch.roll(clutter, 31 * (i + 1), dims=-3), out)
    return out.clamp(0.0, 1.0)


def _perturbation_deltas(d: dict, rot_deg, trans_frac, dist: torch.Tensor) -> torch.Tensor:
    """(..., P, 6) start offsets (w, v): random directions, log-uniform
    magnitudes, translations in units of the camera distance ``dist`` (...)."""
    wdir = d["w"] / torch.linalg.norm(d["w"], dim=-1, keepdim=True).clamp_min(1e-8)
    vdir = d["v"] / torch.linalg.norm(d["v"], dim=-1, keepdim=True).clamp_min(1e-8)
    u = d["m"]
    rmag = float(np.deg2rad(rot_deg[0])) * (rot_deg[1] / rot_deg[0]) ** u[..., 0]
    tmag = dist[..., None] * trans_frac[0] * (trans_frac[1] / trans_frac[0]) ** u[..., 1]
    return torch.cat([wdir * rmag[..., None], vdir * tmag[..., None]], dim=-1)


def _scene_poses(d: dict, ref_rot_deg: float):
    """(T_gt, T_ref, camera distance) of the scenes' pose draws: a look-at
    from the +Z hemisphere with a roll, and the reference pose a small
    random offset from it."""
    dist = _uniform(d["pose"][..., 0], 1.2, 2.0)
    th = _uniform(d["pose"][..., 1], 0.05, 0.9)
    ph = _uniform(d["pose"][..., 2], 0.0, 2 * np.pi)
    center = dist[..., None] * torch.stack([torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph),
                                            torch.cos(th)], -1)
    T_gt = _look_at_w2c(center, _uniform(d["roll"], -np.pi, np.pi))
    dr = d["ref"] / torch.linalg.norm(d["ref"], dim=-1, keepdim=True).clamp_min(1e-8)
    mag = float(np.deg2rad(ref_rot_deg))
    scale = torch.cat([torch.ones_like(dr[..., :3]), torch.full_like(dr[..., 3:], 0.3)], dim=-1)
    return T_gt, T_gt.retract(dr * mag * scale), dist


def _plane_points(u: torch.Tensor) -> torch.Tensor:
    uvp = _uniform(u, -0.45, 0.45)
    return torch.cat([uvp, torch.zeros_like(uvp[..., :1])], dim=-1)


def plane_camera(size: int, device=None) -> Camera:
    return Camera.pinhole(size * 1.2, size * 1.2, (size - 1) / 2, (size - 1) / 2, size, size, device=device)


def synthesize_scenes(d: dict, cfg: BasinTrainConfig, camera: Camera) -> dict:
    """The training scenes of one step's draws ``d`` (batch axis first):
    reference and query images (B, S, S, 3), T_gt / T_ref (B,), points (B,
    N, 3) and the starts' offsets (B, P, 6)."""
    size = cfg.size
    freq_scale = torch.exp(_uniform(d["smooth"], np.log(0.125), 0.0))
    texture = random_texture(cfg.tex_size, freq_scale=freq_scale, device=d["smooth"].device, draws=d["texture"])
    clutter = random_texture(size, device=d["smooth"].device, draws=d["clutter"])
    black, white = torch.zeros_like(clutter), torch.ones_like(clutter)
    # query: clutter x2, black (splat-masked), white; reference: black, white
    qsel = d["qbg"].reshape(-1, 1, 1, 1)
    qbg = torch.where(qsel < 2, clutter, torch.where(qsel == 2, black, white))
    rbg = torch.where(d["rbg"].reshape(-1, 1, 1, 1) == 0, black, white)
    T_gt, T_ref, dist = _scene_poses(d, cfg.ref_rot_deg)
    img_ref = render_plane(texture, rbg, T_ref, camera, (size, size))
    img_qry = render_plane(texture, qbg, T_gt, camera, (size, size))
    img_qry = apply_nuisances(img_qry, clutter, cfg, draws=d["nuisance"])
    return {"img_ref": img_ref, "img_qry": img_qry, "T_gt": T_gt, "T_ref": T_ref,
            "p3d": _plane_points(d["points"]),
            "deltas": _perturbation_deltas(d["perturb"], cfg.rot_deg, cfg.trans_frac, dist)}


# ---------------------------------------------------------- unrolled aligner --
def _pyramid_from_unet(out, idx, scales) -> FeaturePyramid:
    """The L2-normalised pyramid of image ``idx`` (an index or a slice: a
    batched pyramid) of a UNet output."""
    feats = tuple(normalize_features(f[idx]) for f in out["feature_maps"])
    confs = tuple(c[idx] for c in out["confidences"])
    return FeaturePyramid(levels=feats, scales=tuple((1.0 / s, 1.0 / s) for s in scales), confidences=confs)


def unrolled_align_loss(levels: Tuple[LevelData, ...], T_init: Pose, T_gt: Pose, camera: Camera,
                        cfg: BasinTrainConfig, acfg: AlignConfig) -> torch.Tensor:
    """K damped GN steps a level, coarse to fine, through the production
    residuals; the loss of each start (T_init's batch shape) is the mean of
    its clamped mean reprojection error (px, against T_gt, broadcast like
    T_init) after every step, so early steps must already contract."""
    n_scene = levels[0].p3d.ndim - 2
    extra = T_init.t.ndim - 1 - n_scene

    def lift(x):
        return x.reshape(*x.shape[:n_scene], *[1] * extra, *x.shape[n_scene:])

    p3d, mask = lift(levels[0].p3d), lift(levels[0].mask)
    uv_gt, vis_gt = camera.project(T_gt.transform(p3d))
    eye = torch.eye(6, device=p3d.device)

    def reproj_loss(T):
        uv, vis = camera.project(T.transform(p3d))
        err = torch.linalg.norm(uv - uv_gt, dim=-1).clamp_max(cfg.reproj_clip_px)
        ok = (vis & vis_gt & mask).float()
        return (err * ok).sum(-1) / ok.sum(-1).clamp_min(1.0)

    def gn_step(T, data):
        r, J, w, _, _ = _residuals_and_jacobian(T, data, camera, acfg)
        g = torch.einsum("...nck,...nc->...k", J, r * w[..., None])
        Hm = torch.einsum("...nck,...ncl->...kl", J * w[..., None, None], J)
        Hd = Hm + (cfg.lam * torch.diagonal(Hm, dim1=-2, dim2=-1) + 1e-6)[..., None, :] * eye
        # solve_ex: no host sync for its error check (a singular system gives
        # a non-finite step, zeroed below, as JAX's solve does)
        delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
        return T.retract(torch.where(torch.isfinite(delta), delta, 0.0))

    loss = 0.0
    T = T_init
    for data in reversed(levels):
        acc = 0.0
        for _ in range(cfg.k_steps):
            T = gn_step(T, data)
            acc = acc + reproj_loss(T)
        loss = loss + acc
    return loss / (cfg.k_steps * len(levels))


# ----------------------------------------------------------------- training ---
def make_basin_loss_fn(model: UNetExtractor, cfg: BasinTrainConfig):
    """``loss_fn(generator=None, draws=None)``: the mean over ``cfg.batch``
    scenes x ``cfg.n_perturb`` starts of the unrolled align loss, on the
    model's device; ``loss_fn.draws(generator)`` makes a step's draws and
    ``loss_fn.timer``, when set to a callable(label), is called at each part's
    end (``chip_smoke``'s step split)."""
    device = next(model.parameters()).device
    camera = plane_camera(cfg.size, device)
    acfg = AlignConfig(robust_c=1.0)

    def mark(label):
        if loss_fn.timer is not None:
            loss_fn.timer(label)

    def loss_fn(generator=None, draws=None):
        d = draws or scene_draws(cfg, generator, device)
        with torch.no_grad():
            sc = synthesize_scenes(d, cfg, camera)
        mark("scenes")
        B = sc["img_ref"].shape[0]
        out = model(torch.cat([sc["img_ref"], sc["img_qry"]]))
        mark("unet")
        ones = torch.ones(sc["p3d"].shape[:-1], dtype=torch.bool, device=device)
        f_ref, w_ref, v_ref = observe_points(_pyramid_from_unet(out, slice(0, B), model.scales), sc["T_ref"],
                                             camera, sc["p3d"], ones)
        levels = build_level_data(_pyramid_from_unet(out, slice(B, 2 * B), model.scales), f_ref, w_ref, v_ref,
                                  sc["p3d"], ones)
        mark("observation")
        T_gt = Pose(R=sc["T_gt"].R[:, None].expand(-1, cfg.n_perturb, -1, -1),
                    t=sc["T_gt"].t[:, None].expand(-1, cfg.n_perturb, -1))
        loss = unrolled_align_loss(levels, T_gt.retract(sc["deltas"]), T_gt, camera, cfg, acfg).mean()
        mark("unrolled GN")
        return loss

    loss_fn.timer = None
    loss_fn.draws = lambda generator: scene_draws(cfg, generator, device)
    return loss_fn


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def graphed_loss_and_grads(loss_fn, params, draws: dict):
    """The loss, its backward into the parameters' ``.grad`` and the global
    norm clip, captured once as a CUDA graph over static draw buffers (the
    eager step is host-bound: ~40k small ops). Returns ``run(draws) ->
    (loss, global gradient norm)``: copies the draws in, replays, and points
    each ``.grad`` at its static gradient. The same kernels as the eager
    step, in the same order."""
    def step(d):
        loss = loss_fn(draws=d)
        loss.backward()
        return loss, clip_by_global_norm(params, 1.0)

    static = _tree_map(torch.clone, draws)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            for p in params:
                p.grad = None
            step(static)
    torch.cuda.current_stream().wait_stream(side)
    for p in params:
        p.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(static)
    grads = [p.grad for p in params]

    def run(d: dict):
        _tree_map(lambda a, b: a.copy_(b), static, d)
        graph.replay()
        for p, g in zip(params, grads):
            p.grad = g
        return out

    return run


def train_basin_features(
    cfg: BasinTrainConfig = BasinTrainConfig(),
    seed: int = 0,
    model: Optional[UNetExtractor] = None,
    callback=None,
    device=None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Iterable[dict]] = None,
):
    """Train the UNet (``model``, else ``init_unet`` from ``seed``) through
    the unrolled aligner with optax.chain(clip_by_global_norm(1.0),
    adam(lr)); returns (model, info): the logged (step, loss) history, the
    global gradient norm at each logged step, and the seconds. Draws come
    from ``generator`` (on the device, seeded ``seed + 1`` by default) or
    ``draws``, one dict a step. ``callback(step, loss, grad_norm)``. On the
    card the loss, its backward and the clip run as one CUDA graph
    (:func:`graphed_loss_and_grads`)."""
    device = resolve(device)
    model = model if model is not None else init_unet(torch.Generator().manual_seed(seed), device=device)
    loss_fn = make_basin_loss_fn(model, cfg)
    params = list(model.parameters())
    opt = Adam(params, lambda k: cfg.lr)
    gen = generator or torch.Generator(device=device).manual_seed(seed + 1)
    draws = iter(draws) if draws is not None else None
    history, grad_norms = [], []
    t0 = time.time()
    with true_f32():
        step_fn = None
        for i in range(cfg.n_steps):
            d = next(draws) if draws is not None else loss_fn.draws(gen)
            if device.type == "cuda":
                step_fn = step_fn or graphed_loss_and_grads(loss_fn, params, d)
                loss, gnorm = step_fn(d)
            else:
                loss = loss_fn(draws=d)
                loss.backward()
                gnorm = clip_by_global_norm(params, 1.0)
            opt.step()
            if (i + 1) % cfg.log_every == 0 or i == 0:
                lv, gn = float(loss.detach()), float(gnorm)
                history.append((i + 1, lv))
                grad_norms.append((i + 1, gn))
                if callback:
                    callback(i + 1, lv, gn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model, {"history": history, "grad_norms": grad_norms, "seconds": time.time() - t0}
