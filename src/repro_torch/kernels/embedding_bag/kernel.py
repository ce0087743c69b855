"""The bag reduce's CUDA kernel: build, binding and launch wrapper.

``csrc/embedding_bag.cu`` holds one kernel written by hand for Hopper
(``sm_90a``), replacing the Pallas TPU kernel ``_bag_kernel`` of the JAX
package (``kernels/embedding_bag/kernel.py``). It is compiled at first use
with ``nvcc`` into a shared library with a plain C interface under
``.cache/repro_torch_kernels/`` of the checkout, keyed by a hash of the
source and flags, and loaded with ``ctypes`` (``kernels/_nvcc.py``).
Importing this module builds nothing.

The wrapper takes tensors on one device. On CPU tensors it returns the
kernel's plain version, ``ref.bag_reduce_plain``; on CUDA tensors it
launches the kernel on the current stream or raises — nothing falls back.
It counts its launches in ``bag_reduce.launches``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._nvcc import I64, INT, NVCC_FLAGS, PTR, CudaLibrary, data_ptr
from repro_torch.kernels.embedding_bag import ref

__all__ = ["DTYPES", "NVCC_FLAGS", "bag_reduce", "build"]

SOURCE = Path(__file__).parent / "csrc" / "embedding_bag.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes

_LIB = CudaLibrary(
    SOURCE,
    {"eb_bag_reduce": [PTR, PTR, I64, I64, I64, PTR, INT, PTR]},
    error_fn="eb_error_string",
)


def build() -> tuple[Path, float, str]:
    """Compile the kernel if needed: (library path, seconds, compiler log)."""
    return _LIB.build()


def bag_reduce(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b, d] = sum_l w[b, l] * rows[b, l, d], fp32 sums, ``rows.dtype`` out.

    ``rows`` is [B, L, D] and ``w`` [B, L], both float32 or both bfloat16.
    """
    for name, t, ndim in (("rows", rows, 3), ("w", w, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if w.dtype != rows.dtype:
        raise TypeError(f"w is {w.dtype} but rows are {rows.dtype}")
    B, L, D = rows.shape
    if tuple(w.shape) != (B, L):
        raise ValueError(f"w has shape {tuple(w.shape)}, rows need {(B, L)}")
    if rows.device.type == "cpu":
        if w.device != rows.device:
            raise ValueError(f"w is on {w.device}, rows on {rows.device}")
        return ref.bag_reduce_plain(rows, w)
    if rows.device.type != "cuda":
        raise ValueError(f"bag_reduce runs on cuda or cpu, not {rows.device}")
    if w.device != rows.device:
        raise ValueError(f"w is on {w.device}, rows on {rows.device}")
    out = torch.empty((B, D), dtype=rows.dtype, device=rows.device)
    if B * D == 0:
        return out
    _LIB.launch_on(rows.device, "eb_bag_reduce", data_ptr(rows), data_ptr(w), B, L, D,
                   data_ptr(out), DTYPES[rows.dtype])
    bag_reduce.launches += 1
    return out


bag_reduce.launches = 0
