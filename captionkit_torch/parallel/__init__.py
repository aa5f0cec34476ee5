"""Data parallelism over ``torch.distributed`` (``captionkit.parallel``):
one process per rank, parameters replicated, every global batch split by
rows, the gradients summed by the steps themselves (``parallel/mesh.py``)."""

from captionkit_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Ranks,
    batch_sharding,
    close_ranks,
    init_ranks,
    make_mesh,
    shard_batch_arrays,
    stacked_batch_sharding,
)
