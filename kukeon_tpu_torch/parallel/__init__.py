"""Serving and training on a mesh of the port: torch counterparts of
``kukeon_tpu/parallel`` (mesh and sharding), the rank groups they run over
(``launch``), and the collectives that autograd differentiates
(``autograd``)."""

from kukeon_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    Mesh,
    auto_mesh_shape,
    largest_pow2_leq,
    make_mesh,
    serving_mesh,
)
from kukeon_tpu_torch.parallel.sharding import (  # noqa: F401
    kv_cache_spec,
    llama_param_specs,
    shard_params,
    specs_for_params,
)
