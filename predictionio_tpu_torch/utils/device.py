"""Device resolution for every entry point of the port.

The rule: an entry point runs on ``cuda`` unless its caller asks for the
CPU (``device="cpu"``, or ``--device cpu`` on the CLI). Without a card and
without that request it raises — it never quietly runs on the CPU.

Resolving a device also pins float32 matrix products to full float32
(no TF32): the exact scorer's answers and the two-stage rescore are
compared against f32 references, and TF32 keeps about three digits.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises
    ``RuntimeError``; ``"cpu"`` is always honoured."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the CLI) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
