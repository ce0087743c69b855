"""Build and load the port's CUDA sources: ``nvcc`` into plain-C libraries.

Each kernel module keeps one ``.cu`` source under its ``csrc/``. At first
use, ``CudaLibrary.build`` compiles it with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``.cache/repro_torch_kernels/``
of the checkout, named by a hash of the source and the flags, and
``CudaLibrary.launch`` loads it with ``ctypes`` and calls one of its entry
points (``launch_on``: on a device's current stream). Every entry point
returns ``cudaGetLastError()``; a non-zero code raises with the library's
own error string. The entry points' ctypes functions are bound once, when
the library loads. Importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "data_ptr", "find_nvcc"]

BUILD_DIR = Path(__file__).resolve().parents[3] / ".cache" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


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
        "nvcc not found in $CUDA_HOME/bin or on PATH; the port's CUDA kernels "
        "are built from source at first use"
    )


def data_ptr(t: torch.Tensor) -> int:
    """The address of a contiguous tensor's data, for a ``void*`` argument."""
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return t.data_ptr()


class CudaLibrary:
    """One ``.cu`` source, built at first use and loaded with ``ctypes``.

    ``signatures`` maps each exported entry point to its ``argtypes``; every
    entry point returns an ``int`` CUDA error code, and ``error_fn`` names
    the exported ``const char* (int)`` that turns a code into its message.
    """

    def __init__(self, source: Path, signatures: dict, error_fn: str):
        self.source = Path(source)
        self.signatures = dict(signatures)
        self.error_fn = error_fn
        self._lock = threading.RLock()  # build() runs under it from _load()
        # The entry points' ctypes functions by name, bound once at load,
        # and whether the process sees one card (fixed once CUDA starts).
        self._fns: dict | None = None
        self._one_device = False

    def path(self) -> Path:
        """``BUILD_DIR/lib<stem>-<hash>.so``; the hash covers source and flags."""
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def build(self) -> tuple[Path, float, str]:
        """Compile the source if needed: (library path, seconds, compiler log).

        An edited source or flag set is rebuilt under a new name, and a warm
        cache costs nothing (0 seconds, empty log). The compile writes to a
        private name and renames it into place, so concurrent builds never
        load a half-written file.
        """
        lib = self.path()
        with self._lock:
            if lib.exists():
                return lib, 0.0, ""
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
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

    def programs(self) -> int:
        """Libraries this process has loaded for the source: 0 or 1. The
        launchers expose it as ``_cache_size()``, the compile count that
        ``repro_torch.obs.profiler`` reads."""
        return int(self._fns is not None)

    def _load(self) -> dict:
        if self._fns is not None:
            return self._fns
        with self._lock:
            if self._fns is None:
                path, _, _ = self.build()
                cdll = ctypes.CDLL(str(path))
                fns = {}
                for name, argtypes in {self.error_fn: [INT], **self.signatures}.items():
                    fn = getattr(cdll, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_char_p if name == self.error_fn else INT
                    fns[name] = fn
                self._one_device = torch.cuda.device_count() == 1
                self._fns = fns
            return self._fns

    def function(self, name: str):
        """Entry point ``name`` as its ctypes function (the library loaded)."""
        return (self._fns or self._load())[name]

    def launch(self, name: str, *args) -> None:
        """Call entry point ``name``; raise if it returns a CUDA error."""
        err = (self._fns or self._load())[name](*args)
        if err != 0:
            msg = self._fns[self.error_fn](err).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")

    def launch_on(self, device: torch.device, name: str, *args) -> None:
        """Call entry point ``name`` with ``args`` and then ``device``'s
        current stream, with ``device`` current: a device context is opened
        only when another device is current.

        The stream comes from PyTorch's raw-stream getter (an int, as its
        own generated launchers take it), without a ``Stream`` object per
        call; on a host with one card its device is the current one, so the
        current device is read only where there are several.
        """
        self._fns or self._load()  # binds _one_device
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch._C._cuda_getCurrentRawStream(index)
        if self._one_device or index == torch._C._cuda_getDevice():
            self.launch(name, *args, stream)
            return
        with torch.cuda.device(index):
            self.launch(name, *args, stream)
