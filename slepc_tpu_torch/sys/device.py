"""The port's default-device rule, in one place.

Every constructor and generator that takes ``device`` passes it through
:func:`resolve_device`: ``None`` means the device given to
:func:`set_default_device` when one was given, else *the card* -- the
current CUDA device when there is one, else a ``RuntimeError`` that tells
the caller to pass ``device="cpu"``.  There is no quiet CPU fallback: the
CPU is used only when asked for, by ``device=`` or by
``set_default_device("cpu")``.  A tensor handed to a constructor keeps its
own device (the constructors only call this when they have to place new
data).
"""

from __future__ import annotations

from typing import Optional

import torch

_default: Optional[torch.device] = None


def set_default_device(device=None) -> None:
    """The device that ``device=None`` means from now on (None: the card
    again).  A script that may run on either says so once, e.g.
    ``set_default_device(os.environ["SLEPC_TPU_TORCH_DEVICE"])``."""
    global _default
    _default = None if device is None else torch.device(device)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the default set by
    :func:`set_default_device`, else the current CUDA card."""
    if device is not None:
        return torch.device(device)
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            'slepc_tpu_torch runs on a CUDA card by default and found none '
            '(torch.cuda.is_available() is false); pass device="cpu" to run '
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
