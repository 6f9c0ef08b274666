"""Data, tensor, pipeline and sequence parallelism over the ranks of a ``torch.distributed`` process group.

Counterpart of ``neural_sound_generation_tpu/parallel/`` for the mesh's
``data``, ``model`` and ``pipe`` axes: ``distributed`` joins the processes
(one device each), ``mesh`` lays the axes over them (the tensor-parallel
table, ``model_param_shardings``, is in ``training.sharding``),
``pipeline`` runs GPipe's stages over the pipe axis and ``sequence``
shards a 1-D convolution's time axis over any axis with halo exchange
(``halo_conv1d``, ``sharded_conv1d``).
"""

from neural_sound_generation_tpu_torch.parallel.distributed import (  # noqa: F401
    HostTopology,
    barrier,
    initialize,
    loader_shard_args,
    process_group,
    topology,
)
from neural_sound_generation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    current_mesh,
    make_mesh,
    mesh_from_args,
    primary_print,
    shard_batch,
)
from neural_sound_generation_tpu_torch.parallel.sequence import (  # noqa: F401
    halo_conv1d,
    sharded_conv1d,
)
