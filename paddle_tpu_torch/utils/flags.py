"""Flag registry (port of ``paddle_tpu/utils/flags.py``), restricted to the
flags the ported path reads.  The names are the JAX package's, and a
``FLAGS_<name>`` environment variable overrides a default at import, so
the two packages switch alike."""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = value
    return value


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        k = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        _REGISTRY[k] = v


def fast_get(name: str):
    return _REGISTRY.get(name)


# defined and read by nothing, as in the JAX package: the flash route
# is decided by kernels/flash_attention.py:supported() alone
define_flag("use_flash_attention", True, "route attention through the "
            "flash-attention kernel")
define_flag("use_pallas_norm", False,
            "route layer_norm through the CUDA LayerNorm kernels "
            "(kernels/norm_cuda.py); opt-in, as in the JAX package")
# the cross-entropy kernel routes: their kernels are not ported yet, so a
# card's logits raise under either (nn/functional/loss.py)
define_flag("use_pallas_ce", False, "fused softmax cross-entropy kernel")
define_flag("use_pallas_lse", False, "one-pass logsumexp kernel for the "
            "cross-entropy statistics")
