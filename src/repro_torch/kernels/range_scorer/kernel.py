"""The range scorer's CUDA kernels: build, binding and launch wrappers.

``csrc/range_scorer.cu`` holds two kernels written by hand for Hopper
(``sm_90a``), each replacing one Pallas TPU kernel of the JAX package:

  * ``scatter_accumulate`` — range-local impact accumulation, on every
    scored range;
  * ``unpack_locals`` — decode of bit-packed docid deltas to range-local
    ids, under ``docs_format="packed"``.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``.cache/repro_torch_kernels/`` of the
checkout, keyed by a hash of the source and flags, and loaded with
``ctypes`` (``kernels/_nvcc.py``). Importing this module builds nothing.

Each wrapper takes tensors on one device. On a CPU tensor it returns its
kernel's plain version from ``ref.py``; on a CUDA tensor it launches the
kernel on the current stream or raises — nothing falls back. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._nvcc import I64, NVCC_FLAGS, PTR, CudaLibrary, find_nvcc
from repro_torch.kernels._nvcc import data_ptr as _ptr
from repro_torch.kernels.range_scorer import ref

__all__ = ["NVCC_FLAGS", "build", "find_nvcc", "scatter_accumulate", "unpack_locals"]

SOURCE = Path(__file__).parent / "csrc" / "range_scorer.cu"
BLOCK = ref.BLOCK

_LIB = CudaLibrary(
    SOURCE,
    {
        "rs_scatter_accumulate": [PTR, PTR, I64, PTR, I64, PTR],
        "rs_unpack_locals": [PTR, I64, PTR, PTR, PTR, PTR, PTR, PTR, I64, PTR, PTR],
    },
    error_fn="rs_error_string",
)


def build() -> tuple[Path, float, str]:
    """Compile the kernels if needed: (library path, seconds, compiler log)."""
    return _LIB.build()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")


def _same_device(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def scatter_accumulate(ids: torch.Tensor, vals: torch.Tensor, s_pad: int) -> torch.Tensor:
    """acc[s] = sum of vals at ids == s, for s in [0, s_pad); int32 [s_pad].

    ``ids`` and ``vals`` are int32 [P]; ids < 0 or >= s_pad are dropped.
    """
    _check(ids, "ids", torch.int32, 1)
    _check(vals, "vals", torch.int32, 1)
    if ids.shape != vals.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and vals {tuple(vals.shape)} differ")
    s_pad = int(s_pad)
    if s_pad <= 0:
        raise ValueError(f"s_pad must be positive, got {s_pad}")
    if ids.device.type == "cpu":
        return ref.scatter_accumulate_ref(ids, vals, s_pad)
    if ids.device.type != "cuda":
        raise ValueError(f"scatter_accumulate runs on cuda or cpu, not {ids.device}")
    _same_device(ids.device, vals=vals)
    acc = torch.zeros(s_pad, dtype=torch.int32, device=ids.device)
    if ids.numel() == 0:
        return acc
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        _LIB.launch(
            "rs_scatter_accumulate",
            _ptr(ids), _ptr(vals), ids.numel(), _ptr(acc), s_pad, stream,
        )
    scatter_accumulate.launches += 1
    return acc


scatter_accumulate.launches = 0


def unpack_locals(
    pack_words: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    pack_dir: torch.Tensor,
    pack_firsts: torch.Tensor,
    keep: torch.Tensor,
    range_start,
) -> torch.Tensor:
    """Decode packed blocks to [B*BLOCK] range-local ids (-1 invalid).

    ``pack_words`` is the int32 tensor carrying the uint32 delta stream;
    ``starts``, ``lens``, ``pack_dir`` and ``pack_firsts`` are int32 [B],
    ``keep`` is bool [B], and ``range_start`` a 0-d int32 tensor (or int).
    """
    _check(pack_words, "pack_words", torch.int32, 1)
    B = starts.shape[0] if isinstance(starts, torch.Tensor) else -1
    for name, t in (("starts", starts), ("lens", lens), ("pack_dir", pack_dir),
                    ("pack_firsts", pack_firsts)):
        _check(t, name, torch.int32, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, starts has {B}")
    _check(keep, "keep", torch.bool, 1)
    if keep.shape[0] != B:
        raise ValueError(f"keep has {keep.shape[0]} rows, starts has {B}")
    device = starts.device
    if not isinstance(range_start, torch.Tensor):
        range_start = torch.tensor(int(range_start), dtype=torch.int32, device=device)
    _check(range_start, "range_start", torch.int32, 0)
    if device.type == "cpu":
        return ref.unpack_locals_ref(
            pack_words, starts, lens, pack_dir, pack_firsts, keep, range_start
        )
    if device.type != "cuda":
        raise ValueError(f"unpack_locals runs on cuda or cpu, not {device}")
    _same_device(
        device, pack_words=pack_words, lens=lens, pack_dir=pack_dir,
        pack_firsts=pack_firsts, keep=keep, range_start=range_start,
    )
    out = torch.empty(B * BLOCK, dtype=torch.int32, device=device)
    if B == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _LIB.launch(
            "rs_unpack_locals",
            _ptr(pack_words), pack_words.numel(), _ptr(starts), _ptr(lens),
            _ptr(pack_dir), _ptr(pack_firsts), _ptr(keep), _ptr(range_start),
            B, _ptr(out), stream,
        )
    unpack_locals.launches += 1
    return out


unpack_locals.launches = 0
