"""paddle_tpu_torch.distributed (port of ``paddle_tpu.distributed``).

Ported so far: :mod:`.store`, the TCP key-value store that the host KV
tier's cluster prefix index, the replicated fleet's routing views and the
cross-host telemetry publish through; and :mod:`.recompute`, activation
recompute, which runs on one device.  Collectives, meshes, the model-
parallel layers, sharding, pipelines and the launcher are ROADMAP.md
§A5.
"""
from . import store  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
from .store import StoreReplyLostError, TCPStore  # noqa: F401

__all__ = ["store", "TCPStore", "StoreReplyLostError", "recompute",
           "recompute_sequential"]
