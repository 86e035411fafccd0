"""Multi-device execution (counterpart of the JAX ``parallel/``):
``torch.distributed`` with one process a rank and a device a process.

* data parallelism: ``make_train_step(..., mesh=)`` averages the gradients,
  the loss and the float buffers over the mesh's 'data' axis;
* point parallelism: the sharded ops split a cloud over a 'points' axis
  (``sharded_ops.py`` states the convention: a sharded argument is the
  rank's shard, a replicated one is whole).
"""

from pytorch_points_tpu_torch.parallel.data_parallel import (
    make_train_step,
    reconstruction_loss,
)
from pytorch_points_tpu_torch.parallel.mesh import make_mesh
from pytorch_points_tpu_torch.parallel.sharded_ops import (
    ball_query_sharded,
    chamfer_sharded,
    earth_mover_distance_sharded,
    furthest_point_sample_sharded,
    group_points_sharded,
    knn_sharded,
    nndistance_ring,
    nndistance_sharded,
    sample_and_group_sharded,
    three_interpolate_sharded,
    three_nn_sharded,
)

__all__ = ["ball_query_sharded", "chamfer_sharded",
           "earth_mover_distance_sharded", "furthest_point_sample_sharded",
           "group_points_sharded", "knn_sharded", "make_mesh",
           "make_train_step", "nndistance_ring", "nndistance_sharded",
           "reconstruction_loss", "sample_and_group_sharded",
           "three_interpolate_sharded", "three_nn_sharded"]
