"""Device resolution for the port's entry points, small constants, and the
rounding of reduced-precision operands."""

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


def round_operand(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (round to nearest even) and back to fp32;
    ``x`` itself when ``dtype`` is None.

    A product of two such operands is the JAX package's bf16 product with
    an fp32 result (``preferred_element_type``): a bf16 x bf16 product is
    exact in fp32, so only the summation order can differ.  (``a.to(bf16)
    @ b.to(bf16)`` would round the result to bf16 as well.)  Autograd
    rounds the cotangent of each rounded operand to ``dtype``, as the JAX
    package's VJP of a cast does."""
    return x if dtype is None else x.to(dtype).to(torch.float32)


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
