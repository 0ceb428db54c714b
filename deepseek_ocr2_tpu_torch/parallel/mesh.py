"""The (dp, mp) device mesh over `torch.distributed` (port of
deepseek_ocr2_tpu.parallel.mesh).

- `dp`: data parallelism: each dp rank takes its own rows of a batch
  (pages or sequences), the JAX package's `P("dp", None)`;
- `mp`: model parallelism: attention heads and MLP columns (TP) and the
  routed experts (EP) split over it (`sharding.py`).

Rank r of the mesh sits at (r // mp, r % mp), the row-major layout of the
JAX package's `np.asarray(devices).reshape(dp, mp)`: the mp ranks of one dp
row hold the shards of one replica, the dp ranks of one mp column the same
shard of every replica. Where XLA inserts the collectives from the
shardings, the port calls them itself (`collectives.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (dp, mp) mesh: its coordinates, its device and
    the two process groups it belongs to (its dp row's mp group, its mp
    column's dp group)."""

    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    device: torch.device
    mp_group: Any
    dp_group: Any
    backend: str

    @property
    def rank(self) -> int:
        """The rank's place in the mesh, dp_rank * mp + mp_rank."""
        return self.dp_rank * self.mp + self.mp_rank

    @property
    def size(self) -> int:
        return self.dp * self.mp


def make_mesh(dp: Optional[int] = None, mp: int = 1, ranks: Optional[Sequence[int]] = None,
              device=None) -> Optional[Mesh]:
    """A (dp, mp) mesh over `ranks` (default: every rank of the initialized
    world; dp defaults to len(ranks) // mp). Every rank of the world calls
    it with the same arguments, since each process group is made by every
    rank in the same order (one mp group per dp row, then one dp group per
    mp column); a rank outside `ranks` gets None. `device`: this rank's
    device (default: cuda:(rank % GPUs) in an NCCL world, else the CPU;
    `launch` passes each rank's)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world (parallel.launch)")
    world, me = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    if mp < 1 or n % mp:
        raise ValueError(f"mp={mp} does not divide the {n} ranks of the mesh")
    dp = n // mp if dp is None else dp
    if dp * mp != n:
        raise ValueError(f"dp*mp ({dp}*{mp}) != rank count {n}")
    mp_groups = [dist.new_group(ranks[i * mp:(i + 1) * mp]) for i in range(dp)]
    dp_groups = [dist.new_group(ranks[j::mp]) for j in range(mp)]
    if me not in ranks:
        return None
    r = ranks.index(me)
    backend = dist.get_backend()
    if device is None:
        from .launch import rank_device

        device = rank_device(me, "cuda" if backend == "nccl" else "cpu")
    return Mesh(dp=dp, mp=mp, dp_rank=r // mp, mp_rank=r % mp, device=torch.device(device),
                mp_group=mp_groups[r // mp], dp_group=dp_groups[r % mp], backend=backend)


def mesh_of(params) -> Optional[Mesh]:
    """The mesh a param tree was sharded onto (`sharding.shard_params`
    stores it under "mesh"; a composite OCR tree keeps it in its "lm"
    tree), or None for unsharded params."""
    if not isinstance(params, dict):
        return None
    if "mesh" in params:
        return params["mesh"]
    lm = params.get("lm")
    return lm.get("mesh") if isinstance(lm, dict) else None


def dp_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Dp rank d's rows [d B / dp, (d + 1) B / dp) of a global batch [B, ...]
    (the JAX package's `P("dp", None)`); the whole batch without a mesh."""
    if mesh is None or mesh.dp == 1:
        return t
    b = t.shape[0]
    if b % mesh.dp:
        raise ValueError(f"batch of {b} rows is not divisible by dp={mesh.dp}")
    n = b // mesh.dp
    return t[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
