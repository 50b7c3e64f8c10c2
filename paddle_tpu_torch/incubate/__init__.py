"""``paddle.incubate`` (port of ``paddle_tpu/incubate``): so far only the
MoE import path, ``incubate.distributed.models.moe`` (ROADMAP.md §A7
has the rest)."""
from . import distributed  # noqa: F401
