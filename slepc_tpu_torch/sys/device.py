"""The port's default-device rule, in one place.

Every constructor and generator that takes ``device`` passes it through
:func:`resolve_device`: ``None`` means *the card* -- the current CUDA device
when there is one, else a ``RuntimeError`` that tells the caller to pass
``device="cpu"``.  There is no quiet CPU fallback.  A tensor handed to a
constructor keeps its own device (the constructors only call this when they
have to place new data).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'slepc_tpu_torch runs on a CUDA card by default and found none '
            '(torch.cuda.is_available() is false); pass device="cpu" to run '
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
