"""The port's device rule: CUDA unless the caller asks for the CPU; and the
constants the modules keep on a device."""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and missing;
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[torch.device], object],
                    device) -> torch.Tensor:
    """``make(device)`` (a numpy array, or a tensor made on ``device``),
    made at the first call for (``key``, ``device``) and kept: a constant a
    module reads at every call. A copy from the host at every call would
    synchronise the stream, and a CUDA graph capture refuses it
    (``diffusion/program.py``). Made outside inference mode, so that
    autograd may read it too."""
    device = torch.device(device)
    k = (key, device)
    if k not in _CONSTANTS:
        with torch.inference_mode(False):
            value = make(device)
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(value).to(device)
            _CONSTANTS[k] = value
    return _CONSTANTS[k]
