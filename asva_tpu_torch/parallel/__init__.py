"""Training and generation across processes (port of asva_tpu/parallel/):
the process group and host collectives of `multihost`, the process meshes
of `mesh` (data x fsdp for training, data x seq for generation), the
collectives of `reduce`, and FSDP's splits of `sharding`."""
from .mesh import (FrameShard, Mesh, batch_sharding, make_gen_mesh,  # noqa
                   make_mesh, replicate)
from .multihost import maybe_initialize_distributed  # noqa: F401
from .reduce import all_reduce_mean_  # noqa: F401
from .sharding import fsdp_shardings, shard_module  # noqa: F401
