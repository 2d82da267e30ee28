"""Distribution of the port over ``torch.distributed``, one rank per process.

Port of mfmg_tpu/parallel/: ``process`` (the rank's ``Mesh``, the
point-to-point and gather collectives, ``launch`` of local ranks),
``spmd`` (the slab/pencil-sharded V-cycle), ``sharding`` (the row-sharded
hierarchy of the ELL and matrix-free fine levels) and ``dist_setup`` (each
rank builds its own slab of the setup).  ``Config.distributed_setup`` and
the driver's ``--spmd N`` run through them.
"""

from mfmg_torch.parallel.process import Mesh, launch, make_mesh
from mfmg_torch.parallel.sharding import shard_hierarchy, shard_vector

__all__ = ["Mesh", "launch", "make_mesh", "shard_hierarchy", "shard_vector"]
