"""Plain PyTorch versions of the weighted bag reduce.

``out[b, d] = sum_l w[b, l] * rows[b, l, d]`` for rows ``[B, L, D]`` and
weights ``[B, L]``. The JAX package has two semantics for it, and so does
the port:

  * :func:`bag_reduce_ref` contracts in the inputs' dtype, as the JAX
    package's ``kernels/embedding_bag/ref.py`` (``impl="xla"``) does;
  * :func:`bag_reduce_plain` upcasts to float32, contracts over L and
    casts back to ``rows.dtype``, as the Pallas kernel ``_bag_kernel``
    does. It is the plain version of the CUDA kernel in ``kernel.py``.

For float32 the two agree; for bfloat16 they round at other places.
"""

from __future__ import annotations

import torch

__all__ = ["bag_reduce_plain", "bag_reduce_ref"]


def bag_reduce_ref(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [B, L, D], w [B, L] -> [B, D], in the inputs' dtype."""
    return torch.einsum("bld,bl->bd", rows, w)


def bag_reduce_plain(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [B, L, D], w [B, L] -> [B, D]: fp32 contraction, ``rows.dtype`` out."""
    f32 = torch.float32
    return torch.einsum("bld,bl->bd", rows.to(f32), w.to(f32)).to(rows.dtype)
