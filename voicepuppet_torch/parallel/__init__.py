"""Data groups over ``torch.distributed`` (``voicepuppet_tpu.parallel``
counterpart).  The JAX ``data_parallel_step`` wraps a step; here a
trainer built with ``mesh=`` runs its step on the rank's rows and
averages the gradients with ``all_reduce_grads_``."""

from voicepuppet_torch.parallel.mesh import (make_mesh, all_reduce_grads_,
                                             shard_batch, shard_batch_local,
                                             local_batch_rows, replicate)

__all__ = ["make_mesh", "all_reduce_grads_", "shard_batch",
           "shard_batch_local", "local_batch_rows", "replicate"]
