"""Several devices: the mesh, its collectives, and the distributed ALS
trainer.

Counterpart of ``oryx_tpu/parallel/`` (reference: the cluster-scale
training path of Spark MLlib's block-partitioned ALS,
app/oryx-app-mllib/.../als/ALSUpdate.java:141-152, and its
executor communication, SURVEY §5.8): shuffles become
all-gathers and sums over the mesh entries (``mesh.py``), within a
process device copies, across processes ``torch.distributed``.
"""

from .mesh import build_mesh, local_mesh
from .als_dist import (
    BlockedRatings,
    block_ratings,
    block_ratings_ring,
    make_train_step,
    train_als_distributed,
)

__all__ = [
    "build_mesh",
    "local_mesh",
    "BlockedRatings",
    "block_ratings",
    "block_ratings_ring",
    "make_train_step",
    "train_als_distributed",
]
