"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A request
for CUDA on a machine without a card raises: nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def full_float32_precision() -> None:
    """Keep float32 convolutions and matrix products in full float32.

    cuDNN runs float32 convolutions in TF32 by default, which keeps
    about three decimal digits; the port's float32 path is the one the
    tests and the chip smoke compare, so TF32 stays off. bfloat16 work
    is unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
