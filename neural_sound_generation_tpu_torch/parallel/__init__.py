"""Data parallelism over the ranks of a ``torch.distributed`` process group.

Counterpart of ``neural_sound_generation_tpu/parallel/`` for the mesh's
``data`` axis: ``distributed`` joins the processes (one device each) and
``mesh`` lays the data axis over them. The model and pipe axes
(``sequence``, ``pipeline``, the tensor-parallel rules) come with later
slices of the port.
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
    MODEL_AXIS,
    PIPE_AXIS,
    DataMesh,
    current_mesh,
    make_mesh,
    mesh_from_args,
    primary_print,
    shard_batch,
)
