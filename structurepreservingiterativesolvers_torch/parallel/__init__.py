"""Row-sharded solves over a ``torch.distributed`` mesh (the port of the JAX
package's ``parallel/``): one process per device, NCCL between CUDA
devices and gloo between CPU processes."""

from .comm import gather, mesh_of, pdot, pnorm, psum  # noqa: F401
from .mesh import (  # noqa: F401
    ROWS,
    make_mesh,
    replicated,
    shard_constraint,
    shard_matrix,
    shard_preconditioner,
    shard_system,
    shard_vector,
)
from .halo_spmv import HaloDia, dia_spmv_halo  # noqa: F401
from .distributed import (  # noqa: F401
    CHIPS,
    HOSTS,
    global_mesh,
    host_chip_mesh,
    init_distributed,
    is_coordinator,
    spawn_local,
)
