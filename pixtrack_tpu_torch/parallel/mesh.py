"""Scale-out over several cards: the (dp, tp) process layout, the sharded
NeRF training step, and batched pose alignment.

Port of ``pixtrack_tpu/parallel/mesh.py``. The JAX package annotates
shardings on a device mesh and XLA inserts the collectives; here one process
runs per card (``torch.distributed``: NCCL when the caller's device is
CUDA, gloo when it is the CPU) and the collectives are explicit, all-reduce
and broadcast only:

- ``dp`` (data parallel): every rank draws the global batch's indices and
  render noise from the same seeded generator and renders its slice; the
  gradients are all-reduced as a mean over its ``dp`` group.
- ``tp`` (tensor parallel): the hash table, one (L, F, T) parameter, is
  sharded over its entries: a rank holds (L, F, T / tp), gathers the
  corners that fall in its range (zeros elsewhere) and the ``tp`` group
  sums the gathered values. Every ``tp`` rank of a ``dp`` group renders the
  same rays, so each gets the same upstream gradient: the sum's backward is
  the identity (an all-reduce there would scale the table's gradient by
  ``tp``). The MLP is replicated.

Rank r runs on ``cuda:r``. ``launch`` spawns the ranks from inside a
command (no ``torchrun``) on a file rendezvous in a temporary directory;
``make_mesh`` in each rank joins it. ``batch_align`` is the tracker's
batched alignment on one card (``sharded_batch_align``'s counterpart: the
LM's batched carry does what ``vmap`` does there).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from pixtrack_tpu_torch.align.lm import AlignConfig, AlignState, LevelData, align_level
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.nerf import render
from pixtrack_tpu_torch.nerf.field import HashEncoding, NGPField
from pixtrack_tpu_torch.nerf.optim import Adam

# a collective that waits longer than this raises in every rank
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_RENDEZVOUS = "PIXTRACK_TORCH_RENDEZVOUS"


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (dp, tp) layout: rank ``r`` is (r // tp,
    r % tp); its ``tp`` group holds the ranks of its row, its ``dp`` group
    those of its column."""

    world: int
    tp: int
    rank: int
    device: torch.device
    backend: str
    tp_group: object
    dp_group: object

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def dp_ranks(self) -> list:
        """The global ranks of this rank's ``dp`` group, by ``dp_rank``."""
        return [d * self.tp + self.tp_rank for d in range(self.dp)]


def cpu_threads(n_ranks: int) -> int:
    """Each of ``n_ranks`` CPU ranks' share of this process's threads."""
    return max(1, torch.get_num_threads() // n_ranks)


def check_devices(n_devices: int, tp: int, device) -> None:
    """Raise unless ``n_devices`` ranks at ``tp`` can run on ``device``'s
    kind: ``tp`` divides ``n_devices``, and on CUDA that many cards are
    visible."""
    if n_devices < 1 or tp < 1 or n_devices % tp:
        raise ValueError(f"--tp {tp} does not divide --devices {n_devices}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > count:
            raise RuntimeError(f"--devices {n_devices} asks for {n_devices} cards; {count} visible")


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, device=None, *,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT, shared_device=None) -> Mesh:
    """Join the process group of ``n_devices`` ranks (None: the launcher's
    world, else every visible card, or one process on the CPU) and build
    the (dp, tp) layout, dp = n_devices / tp.

    ``device`` None or ``"cuda"``: rank r on ``cuda:r`` over NCCL; ``"cpu"``:
    gloo. If NCCL does not initialise, this raises. The rank and the
    rendezvous come from ``launch`` (``RANK`` and a file store); a world of
    one needs neither. Where the process group exists, only the (dp, tp)
    subgroups are built anew (another layout over the same ranks).
    ``shared_device``: every rank on that one device over
    gloo, a test harness for several ranks on one card, never the
    production path (NCCL refuses two ranks on one device)."""
    kind = torch.device("cuda" if device is None else device).type
    if n_devices is None:
        n_devices = int(os.environ.get("WORLD_SIZE", torch.cuda.device_count() if kind == "cuda" else 1))
    rank = int(os.environ.get("RANK", 0))
    if shared_device is None:
        check_devices(n_devices, tp, kind)
        dev = torch.device(f"cuda:{rank}") if kind == "cuda" else torch.device("cpu")
        backend = "nccl" if kind == "cuda" else "gloo"
    else:
        check_devices(n_devices, tp, "cpu")
        dev, backend = torch.device(shared_device), "gloo"
    if not 0 <= rank < n_devices:
        raise RuntimeError(f"rank {rank} outside a world of {n_devices}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        # another layout over the same processes: only the subgroups are new
        if dist.get_world_size() != n_devices or dist.get_backend() != backend:
            raise RuntimeError(f"the process group is {dist.get_backend()} over {dist.get_world_size()} ranks, "
                               f"not {backend} over {n_devices}")
    else:
        init = {"init_method": os.environ[_RENDEZVOUS]} if _RENDEZVOUS in os.environ else {}
        if not init and n_devices > 1:
            raise RuntimeError(f"a world of {n_devices} ranks needs a rendezvous: start the ranks with launch()")
        if not init:
            init = {"store": dist.HashStore()}
        if backend == "nccl":
            init["device_id"] = dev
        dist.init_process_group(backend, rank=rank, world_size=n_devices, timeout=timeout, **init)
    dp = n_devices // tp
    # every rank creates every group, in one order
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    return Mesh(world=n_devices, tp=tp, rank=rank, device=dev, backend=backend,
                tp_group=tp_groups[rank // tp], dp_group=dp_groups[rank % tp])


def _rank_main(rank: int, world: int, tmp: str, threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    os.environ[_RENDEZVOUS] = "file://" + os.path.join(tmp, "store")
    if threads:
        torch.set_num_threads(threads)
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    try:
        out = fn(*args)
    except SystemExit as e:  # a command's stop: its message to the launcher
        raise RuntimeError(f"rank {rank}: {e}") from None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)


def launch(fn: Callable, n_devices: int, *args, join_timeout: Optional[float] = None,
           threads: Optional[int] = None):
    """Run ``fn(*args)`` in ``n_devices`` spawned processes, rank r with
    ``RANK=r`` (``fn`` calls ``make_mesh``), on a file rendezvous in a fresh
    temporary directory, and return rank 0's result (pickled back). A rank
    that raises terminates the others and its error is raised here; after
    ``join_timeout`` seconds the ranks are terminated and TimeoutError
    raised. ``threads``: each rank's CPU threads (ranks on the CPU share its
    cores)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pixtrack_mesh_") as tmp:
        # the call goes through a file: a spawned process reads its pipe only
        # after its imports, so large arguments there start the ranks one by one
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(_rank_main, args=(n_devices, tmp, threads), nprocs=n_devices, join=False,
                                 start_method="spawn")
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10.0)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{n_devices} ranks did not finish in {join_timeout} s")
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


# ----------------------------------------------------------------- the table over tp
class _TpSum(torch.autograd.Function):
    """The sum over the ``tp`` group; its backward is the identity (every
    rank of the group computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class ShardedHashEncoding(HashEncoding):
    """The hash encoding with this rank's shard of the table: (L, F, T / tp),
    entries [tp_rank T / tp, (tp_rank + 1) T / tp). A corner outside the
    range gathers zero; the ``tp`` group's sum gives every rank the values
    of all corners, so the encoding is the unsharded one's: each corner's
    value is one rank's entry plus zeros."""

    def __init__(self, enc: HashEncoding, mesh: Mesh):
        super().__init__(enc.n_levels, enc.features_per_level, enc.log2_table_size, enc.base_res, enc.max_res)
        T = 1 << enc.log2_table_size
        if T % mesh.tp:
            raise ValueError(f"tp {mesh.tp} does not divide the table's {T} entries")
        self.shard, self.group = T // mesh.tp, mesh.tp_group
        self.lo = mesh.tp_rank * self.shard
        self.tables = nn.Parameter(enc.tables.detach()[:, :, self.lo:self.lo + self.shard].clone())
        self.to(enc.tables.device)

    def _gather(self, slots: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            local = slots - self.lo
            inside = (local >= 0) & (local < self.shard)
            local = torch.where(inside, local, 0)
        vals = torch.where(inside[None], super()._gather(local), 0.0)
        return _TpSum.apply(vals, self.group)


def shard_field_params(field: NGPField, mesh: Mesh) -> NGPField:
    """Place ``field`` on the mesh, in place: rank 0's parameters broadcast
    to every rank, then the hash table replaced by this rank's shard over
    ``tp`` (``ShardedHashEncoding``); the MLP replicated. Returns the field."""
    with torch.no_grad():
        for p in field.parameters():
            dist.broadcast(p.data, src=0)
    field.encoding = ShardedHashEncoding(field.encoding, mesh)
    return field


def gather_over_tp(x: torch.Tensor, field: NGPField, mesh: Mesh) -> torch.Tensor:
    """A tensor shaped as this rank's table shard (the table, its gradient,
    Adam's moments) whole, (L, F, T), on every rank: each shard placed in
    zeros and summed over the ``tp`` group."""
    enc = field.encoding
    full = x.new_zeros(enc.n_levels, enc.features_per_level, 1 << enc.log2_table_size)
    full[:, :, enc.lo:enc.lo + enc.shard] = x.detach()
    dist.all_reduce(full, group=mesh.tp_group)
    return full


def gather_field(field: NGPField, mesh: Mesh) -> NGPField:
    """A single-device copy of a sharded field, its table gathered (every
    rank of the ``tp`` group calls this)."""
    full = NGPField(**field.config()).to(field.device)
    with torch.no_grad():
        for name, p in full.named_parameters():
            p.copy_(gather_over_tp(field.encoding.tables, field, mesh) if name == "encoding.tables"
                    else field.get_parameter(name))
    return full


def unshard_field_params(field: NGPField, mesh: Mesh) -> NGPField:
    """The inverse of ``shard_field_params``, in place: the table gathered
    into a single-device ``HashEncoding``. Returns the field."""
    enc = field.encoding
    full = HashEncoding(enc.n_levels, enc.features_per_level, enc.log2_table_size, enc.base_res, enc.max_res)
    with torch.no_grad():
        full.tables = nn.Parameter(gather_over_tp(enc.tables, field, mesh))
    field.encoding = full.to(field.device)
    return field


def mean_over_dp(tensors, mesh: Mesh) -> None:
    """Each tensor replaced, in place, by its mean over this rank's ``dp``
    group: an all-reduce sum, then a division by dp."""
    for t in tensors:
        dist.all_reduce(t, group=mesh.dp_group)
        t.div_(mesh.dp)


def sharded_nerf_train_step(field: NGPField, mesh: Mesh, aabb, optimizer: Optional[Callable] = None,
                            n_coarse: int = 32, n_fine: int = 0, background: float = 1.0):
    """The NeRF training step over the mesh.

    ``field`` is sharded here if it is not yet (``shard_field_params``).
    ``optimizer`` builds the optimizer from the sharded field's parameters
    (its moments are then sharded as the table is); by default the JAX
    step's ``optax.adam(1e-2, b1=0.9, b2=0.99, eps=1e-15)``. Returns
    (step_fn, optimizer): ``step_fn(origins, dirs, target, generator) ->
    loss`` takes the GLOBAL batch (the same on every rank), draws the render
    noise of the whole batch from ``generator`` (as the one-process render
    draws it), renders this rank's ``dp`` slice, all-reduces the gradients
    as a mean over ``dp`` and steps the optimizer; the loss returned is the
    global batch's."""
    if not isinstance(field.encoding, ShardedHashEncoding):
        shard_field_params(field, mesh)
    opt = (optimizer or (lambda ps: Adam(ps, lambda k: 1e-2, b1=0.9, b2=0.99, eps=1e-15)))(list(field.parameters()))
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=field.device)

    def step_fn(origins, dirs, target, generator):
        B = origins.shape[0]
        if B % mesh.dp:
            raise ValueError(f"a batch of {B} rays does not divide dp = {mesh.dp}")
        n = B // mesh.dp
        lo = mesh.dp_rank * n
        rcfg = render.RenderConfig(n_coarse=n_coarse, n_fine=n_fine, perturb=True, min_transmittance=1e-4,
                                   chunk=max(n, 1))
        noise = render._draw_noise(B, rcfg, generator, field.device)
        noise = tuple(None if a is None else a[lo:lo + n] for a in noise)
        out = render.render_rays(field, origins[lo:lo + n], dirs[lo:lo + n], aabb, rcfg, noise=noise)
        pred = out["rgb"] + (1.0 - out["alpha"][:, None]) * background
        loss = torch.mean((pred - target[lo:lo + n]) ** 2)
        loss.backward()
        mean_over_dp([p.grad for p in opt.params], mesh)
        opt.step()
        loss = loss.detach()
        mean_over_dp([loss], mesh)
        return loss

    return step_fn, opt


# --------------------------------------------------------------- batched alignment
def batch_align(T_b: Pose, levels_b: LevelData, cam_b: Camera, cfg: AlignConfig = AlignConfig(num_iters=8)
                ) -> AlignState:
    """``align_level`` at 8 iterations over B problems: poses (B,), a level
    whose tensors lead with B (scale (B, 2) or (2,)) and B cameras ((B, 2)
    fields) or one. Returns the (B,)-batched state."""
    return align_level(T_b, levels_b, cam_b, cfg)
