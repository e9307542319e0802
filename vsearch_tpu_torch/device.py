"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Raises when a CUDA device is asked for and none is available: the
    port never carries on quietly on the CPU. Pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels on the host. On a CUDA
    device, f32 products are full f32 (``set_f32_parity``): the port's
    f32 paths mean what the JAX package's ``Precision.HIGHEST`` means.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        set_f32_parity()
    return dev


def set_f32_parity() -> None:
    """Full-precision f32 matmuls and convolutions (no TF32), the
    counterpart of the JAX package's ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
