"""Data parallelism across processes (port of asva_tpu/parallel/): the
process group and host collectives of `multihost`, the process `mesh`, and
the gradient mean and replica broadcast of `reduce`."""
from .mesh import Mesh, batch_sharding, make_mesh, replicate  # noqa: F401
from .multihost import maybe_initialize_distributed  # noqa: F401
from .reduce import all_reduce_mean_  # noqa: F401
