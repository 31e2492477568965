"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. There is no
quiet CPU fallback: without a CUDA device the caller must ask for the CPU
explicitly (``device="cpu"``, as the parity tests do), and on the CPU every
kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for (or defaulted to)
    and no CUDA device exists, and for device types the port does not run
    on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
