"""Dtype policy (port of ``clap2diffusion_tpu/core/dtypes.py``): fp32
parameters, bf16 compute on the tensor cores. The CLI's ``--dtype`` names
the compute type through ``DTypePolicy.from_strings``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_strings(cls, param: str, compute: str) -> "DTypePolicy":
        return cls(param_dtype=DTYPES[param], compute_dtype=DTYPES[compute])
