"""Default device resolution: the port runs on the card unless the caller
asks for the CPU.  There is no silent CPU retreat: without a card and
without an explicit ``device="cpu"``, :func:`resolve_device` raises."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the first card."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device %r asked for, but no CUDA device is "
                               "available" % (str(dev),))
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
