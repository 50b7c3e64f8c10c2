"""``paddle.incubate.distributed`` (reference namespace)."""
from . import models  # noqa: F401
