"""``paddle.distributed.utils`` (port of ``paddle_tpu/distributed/utils.py``;
reference: python/paddle/distributed/utils.py, ``global_scatter``:57 /
``global_gather``:179).  The MoE exchange primitives live in
:mod:`.moe`; re-exported here at the reference's import path."""
from .moe import global_gather, global_scatter  # noqa: F401

__all__ = ["global_scatter", "global_gather"]
