"""``paddle.incubate`` (port of ``paddle_tpu/incubate``): the MoE import
path, ``incubate.distributed.models.moe``, and the checkpoint manager,
``incubate.checkpoint`` (ROADMAP.md §A7 has the rest)."""
from . import checkpoint, distributed  # noqa: F401
