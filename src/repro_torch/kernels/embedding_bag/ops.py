"""Public entry point of the weighted bag reduce.

``impl`` selects the plain PyTorch contraction in the inputs' dtype
(``"torch"``, the counterpart of the JAX package's ``impl="xla"``) or the
CUDA kernel (``"cuda"``, the counterpart of ``impl="pallas"``), which sums
in float32. On CPU tensors ``"cuda"`` runs the kernel's plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import kernel, ref

IMPLS = ("torch", "cuda")

__all__ = ["IMPLS", "bag_reduce"]


def bag_reduce(rows: torch.Tensor, w: torch.Tensor, *, impl: str = "cuda") -> torch.Tensor:
    """rows [B, L, D], w [B, L] -> [B, D]."""
    if impl == "torch":
        return ref.bag_reduce_ref(rows, w)
    if impl == "cuda":
        return kernel.bag_reduce(rows, w)
    raise ValueError(f"impl {impl!r} not in {IMPLS}")
