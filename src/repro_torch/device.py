"""Device selection and float32 policy shared by every entry point."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path explicitly")
    return dev


def full_fp32() -> None:
    """Distances in this port are computed in full float32: TF32 keeps about
    three decimal digits, which would reorder near neighbours. Called by
    every function that computes distances with a matmul."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor on `device`; numpy input is copied (it may be read-only,
    e.g. a view of a JAX array, which torch cannot share)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype)
