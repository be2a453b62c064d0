"""Data parallel over ``torch.distributed`` (``dist.py``)."""
from .dist import (  # noqa: F401
    Mesh, check_replicas, initialize_distributed, local_seeds, make_mesh, on_rank0,
    replicate, shard_batch, sharded_loss_and_grad, spawn,
)
