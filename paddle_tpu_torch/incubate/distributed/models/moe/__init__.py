"""``paddle.incubate.distributed.models.moe``, the reference's MoE import
path (python/paddle/incubate/distributed/models/moe/__init__.py), over
:mod:`paddle_tpu_torch.distributed.moe`."""
from paddle_tpu_torch.distributed.moe import (ExpertFFN, GShardGate,  # noqa
                                              MoELayer, NaiveGate,
                                              SwitchGate, global_gather,
                                              global_scatter)

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate",
           "ExpertFFN", "global_scatter", "global_gather"]
