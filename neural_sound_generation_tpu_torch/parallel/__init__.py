"""Data, tensor and pipeline parallelism over the ranks of a ``torch.distributed`` process group.

Counterpart of ``neural_sound_generation_tpu/parallel/`` for the mesh's
``data``, ``model`` and ``pipe`` axes: ``distributed`` joins the processes
(one device each), ``mesh`` lays the axes over them (the tensor-parallel
table, ``model_param_shardings``, is in ``training.sharding``) and
``pipeline`` runs GPipe's stages over the pipe axis. JAX's ``sequence``
(``halo_conv1d``, ``sharded_conv1d``) is on no CLI path and has no
counterpart yet.
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
