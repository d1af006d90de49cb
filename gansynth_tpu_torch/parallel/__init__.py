"""Data parallelism over a ``torch.distributed`` process group
(``parallel/sharding.py``)."""

from gansynth_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    cache_sharding,
    initialize_multihost,
    make_mesh,
    make_multislice_mesh,
    replicate_on_mesh,
    shard_train_inputs,
)
