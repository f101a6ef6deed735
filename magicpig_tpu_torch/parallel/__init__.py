"""Multi-process serving: tensor parallelism over kv heads, data
parallelism over the batch, and ring prefill over the sequence
(`mesh.py`, `sharded.py`, `ring.py`; ranks started by `launch.py`)."""

from magicpig_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_multihost_mesh,
    shard_engine,
)
