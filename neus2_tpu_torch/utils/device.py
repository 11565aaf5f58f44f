"""Device resolution for the port's entry points, and small constants."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor (``values`` a float or nested tuples), made
    once per (values, dtype, device).

    Made per call, it would be a copy from pageable host memory, and on the
    card every such copy makes the host wait for the device.  Callers share
    the result and must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to the card; asking for CUDA on a machine without
    it raises instead of silently running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
