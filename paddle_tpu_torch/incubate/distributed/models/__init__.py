"""``paddle.incubate.distributed.models`` (reference namespace)."""
from . import moe  # noqa: F401
