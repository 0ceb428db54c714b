"""The collectives of the sharded forward and backward, as autograd
Functions (Megatron's f and g), and the dp reductions of the step.

- `copy_to_mp`: identity forward, all-reduce over mp backward. A region
  whose weights split over mp (attention, the MLPs, the routed experts,
  lm_head) takes its replicated input through it, so the input's gradient
  is the sum of every shard's part.
- `reduce_from_mp`: all-reduce over mp forward, identity backward: the
  partial outputs of a row-parallel product (wo, down) or of each rank's
  experts. The callers hand it f32 partials and round the sum once, as the
  unsharded product rounds its f32 accumulator once.
- `gather_from_mp`: all-gather over mp forward (vocab-sharded logits), the
  rank's slice of the gradient backward.
- `dp_mean_`, `all_reduce_sum`, `all_gather_dp`: the step's gradient mean
  over dp, sums of scalars (mask counts, squared norms) and the rows of a
  batch gathered over dp; `mp_broadcast_`: the vision towers' gradients
  made equal over mp.
- `timed()`: the wall time, calls and bytes of the collectives of a block
  (the step's collective share in `chip_smoke.py` phase 9).

Only `all_reduce`, `all_gather` and `broadcast` run, the collectives every
gloo build has (older ones have no reduce-scatter). gloo takes all three
on CUDA tensors (it stages them through host memory itself), so a world of
ranks sharing one card hands them the card's tensors as NCCL would. Every
function is the identity on a group of one rank or without a mesh. A
failed collective raises and is never retried another way.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

# Under `timed()`: the wall seconds, calls and bytes of this process's
# collectives, each timed between two device synchronizations.
_TIMES: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def timed():
    """Time every collective of the block (each between two device
    synchronizations, so that the compute before it is not counted);
    yields {"seconds", "calls", "bytes"}, filled when the block ends.
    Outside it the collectives are not synchronized or timed."""
    global _TIMES
    _TIMES = {"seconds": 0.0, "calls": 0, "bytes": 0}
    out = _TIMES
    try:
        yield out
    finally:
        _TIMES = None


@contextlib.contextmanager
def _clock(t: torch.Tensor):
    if _TIMES is None:
        yield
        return
    cuda = t.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(t.device)
    _TIMES["seconds"] += time.perf_counter() - t0
    _TIMES["calls"] += 1
    _TIMES["bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place."""
    with _clock(t):
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    with _clock(t):
        dist.all_gather(parts, t, group=group)
    return parts


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` from global rank `src` to every rank of `group`, in place."""
    with _clock(t):
        dist.broadcast(t, src, group=group)
    return t


def mp_on(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` splits the params over more than one mp rank."""
    return mesh is not None and mesh.mp > 1


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh.mp_group), None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.contiguous().clone(), mesh.mp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return torch.cat(_all_gather(x, mesh.mp_group, mesh.mp), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.mesh.mp_rank * ctx.n, ctx.n).contiguous(), None


def copy_to_mp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return _CopyToMp.apply(x, mesh) if mp_on(mesh) else x


def reduce_from_mp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return _ReduceFromMp.apply(x, mesh) if mp_on(mesh) else x


def gather_from_mp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """[..., V / mp] on each mp rank -> [..., V], the ranks' slices in mp
    order."""
    return _GatherFromMp.apply(x, mesh) if mp_on(mesh) else x


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """A new tensor: `t` summed over the mesh's "dp" or "mp" axis (no
    autograd: counts and norms)."""
    size = 0 if mesh is None else (mesh.dp if axis == "dp" else mesh.mp)
    if size <= 1:
        return t
    return _all_reduce(t.detach().clone(), mesh.dp_group if axis == "dp" else mesh.mp_group)


def dp_mean_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Each tensor replaced, in place, by its mean over dp, summed in f32
    (gradients of the rank's rows -> the batch's)."""
    if mesh is None or mesh.dp == 1:
        return
    for t in tensors:
        if t.dtype == torch.float32:
            _all_reduce(t, mesh.dp_group).div_(mesh.dp)
        else:
            t.copy_(_all_reduce(t.float(), mesh.dp_group) / mesh.dp)


def mp_broadcast_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Each tensor replaced, in place, by the mp group's first rank's: for
    whole leaves whose gradient every mp rank computes itself with atomic
    adds (the vision towers' index backward on the card), whose sums may
    round differently from rank to rank and run to run; the replicas then
    stay equal."""
    if not mp_on(mesh):
        return
    src = dist.get_global_rank(mesh.mp_group, 0)
    for t in tensors:
        broadcast_(t, src, mesh.mp_group)


def all_gather_dp(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every dp rank's rows [B / dp, ...] -> the batch [B, ...] on every
    rank, in dp order."""
    if mesh is None or mesh.dp == 1:
        return t
    return torch.cat(_all_gather(t, mesh.dp_group, mesh.dp), dim=0)



def equal_across(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh], axis: str) -> bool:
    """Whether every tensor is bit-equal on every rank of the mesh's "mp"
    or "dp" group (its first rank broadcasts, each rank compares, the
    counts of differences are summed over the group)."""
    size = 0 if mesh is None else (mesh.dp if axis == "dp" else mesh.mp)
    if size <= 1:
        return True
    group = mesh.dp_group if axis == "dp" else mesh.mp_group
    src = dist.get_global_rank(group, 0)
    n_diff = sum(not torch.equal(broadcast_(t.detach().clone(), src, group), t) for t in tensors)
    flag = torch.tensor([float(n_diff)], device=mesh.device)
    return float(_all_reduce(flag, group)[0]) == 0.0
