"""Where the port runs, and which implementation runs there.

The entry points run on the card unless the caller asks for the CPU:
``resolve_device`` turns the default ``"cuda"`` into the card or raises when
there is none. ``resolve_impl`` picks the implementation from the tensors'
device when the caller names none: the hand-written kernels on CUDA, the
plain PyTorch versions on the CPU. The kernels cannot run on the CPU, so
``impl="kernel"`` there raises; ``impl="plain"`` on CUDA is allowed (the
on-card comparisons use it) but is never chosen silently.
"""

from __future__ import annotations

from typing import Optional

import torch

IMPLS = ("kernel", "plain")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return dev


def resolve_impl(impl: Optional[str], device) -> str:
    """``impl`` for work on ``device``: None picks "kernel" on CUDA and
    "plain" elsewhere; "kernel" off CUDA raises."""
    dev = torch.device(device)
    if impl is None:
        return "kernel" if dev.type == "cuda" else "plain"
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "kernel" and dev.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA device, got {dev}: the "
                         "CPU has only the plain PyTorch path")
    return impl
