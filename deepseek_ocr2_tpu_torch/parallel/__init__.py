"""Multi-device execution over `torch.distributed` (port of
deepseek_ocr2_tpu.parallel): the (dp, mp) mesh, the TP / EP / DP layout of
the LM's parameters (plain, int8 or int4), the collectives of the sharded
forward and backward, and `launch`, which starts a world of ranks from one
command."""

from .mesh import Mesh, dp_rows, make_mesh, mesh_of  # noqa: F401
from .sharding import gather_leaves, gather_params, lm_param_specs, lm_param_specs_q8, shard_params  # noqa: F401
