"""Data and tensor parallelism over the ranks of a ``torch.distributed`` process group.

Counterpart of ``neural_sound_generation_tpu/parallel/`` for the mesh's
``data`` and ``model`` axes: ``distributed`` joins the processes (one
device each) and ``mesh`` lays the two axes over them (the tensor-parallel
table, ``model_param_shardings``, is in ``training.sharding``). The pipe
axis (``sequence``, ``pipeline``) comes with a later slice of the port.
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
    PIPE_AXIS,
    Mesh,
    current_mesh,
    make_mesh,
    mesh_from_args,
    primary_print,
    shard_batch,
)
