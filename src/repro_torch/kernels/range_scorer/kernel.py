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
``ctypes``. Importing this module builds nothing.

Each wrapper takes tensors on one device. On a CPU tensor it returns its
kernel's plain version from ``ref.py``; on a CUDA tensor it launches the
kernel on the current stream or raises — nothing falls back. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels.range_scorer import ref

__all__ = ["NVCC_FLAGS", "build", "find_nvcc", "scatter_accumulate", "unpack_locals"]

SOURCE = Path(__file__).parent / "csrc" / "range_scorer.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / ".cache" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BLOCK = ref.BLOCK

_build_lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``; raises if neither."""
    home = os.environ.get("CUDA_HOME")
    if home:
        nvcc = os.path.join(home, "bin", "nvcc")
        if os.path.isfile(nvcc) and os.access(nvcc, os.X_OK):
            return nvcc
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin or on PATH; the range-scorer kernels "
        "are built from source at first use"
    )


def build() -> tuple[Path, float, str]:
    """Compile the kernels if needed: (library path, seconds, compiler log).

    The library name carries a hash of the source and the flags, so an
    edited source is rebuilt and a warm cache costs nothing (0 seconds,
    empty log). The compile writes to a private name and renames it into
    place, so concurrent builders never load a half-written file.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"librange_scorer-{digest.hexdigest()[:16]}.so"
    with _build_lock:
        if lib.exists():
            return lib, 0.0, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
        return lib, seconds, proc.stdout + proc.stderr


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rs_error_string.argtypes = [ctypes.c_int]
    lib.rs_error_string.restype = ctypes.c_char_p
    lib.rs_scatter_accumulate.argtypes = [ptr, ptr, i64, ptr, i64, ptr]
    lib.rs_scatter_accumulate.restype = ctypes.c_int
    lib.rs_unpack_locals.argtypes = [
        ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr, ptr
    ]
    lib.rs_unpack_locals.restype = ctypes.c_int
    return lib


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


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = _lib().rs_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} ({msg})")


def _ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return t.data_ptr()


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
        _launch(
            _lib().rs_scatter_accumulate,
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
        _launch(
            _lib().rs_unpack_locals,
            _ptr(pack_words), pack_words.numel(), _ptr(starts), _ptr(lens),
            _ptr(pack_dir), _ptr(pack_firsts), _ptr(keep), _ptr(range_start),
            B, _ptr(out), stream,
        )
    unpack_locals.launches += 1
    return out


unpack_locals.launches = 0
