"""Multi-device parallelism (counterpart of ``evennicer_slam_tpu/parallel``).
Production: ray data parallelism and the concurrent device groups
(``sharding.py``). The grid-channel tensor parallelism of ``tp_example.py``
is an example; import it explicitly."""

from evennicer_slam_tpu_torch.parallel.sharding import (
    gather_rows,
    pipeline_dp_devices,
    shard_rows,
)

__all__ = ["gather_rows", "pipeline_dp_devices", "shard_rows"]
