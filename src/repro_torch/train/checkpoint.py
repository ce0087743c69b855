"""Async, atomic checkpointing in the JAX package's on-disk format.

The counterpart of the JAX package's ``train/checkpoint.py``. Layout:
``<dir>/step_<N>/shard0.npz`` (one ``.npy`` member per leaf, named by its
tree path, ``params/dense/attn/wq``) and ``manifest.json`` (step, each
array's shape and dtype, ``n_hosts``), written LAST and atomically (tmp +
rename): a checkpoint without a manifest is invisible to restore, so a
preemption mid-write can never corrupt state.

  * async: the device-to-host copy happens on the caller thread, the file
    IO on a background thread; ``wait()`` joins;
  * keep_last keeps disk bounded.

A state is the reference's nested tree (dicts and lists) of numpy arrays
or tensors, stacked as the reference stacks it (``Arch.params_to_numpy``,
``Arch.opt_state_to_numpy``), so that either package restores the other's
checkpoint array for array. A bfloat16 leaf is written as the reference
writes an ``ml_dtypes`` bfloat16 array: a ``<V2`` member of its bits, and
``"bfloat16"`` in the manifest. The reference's own restore returns such a
leaf as a ``|V2`` array (ROADMAP C4); this one reads it back as bfloat16
with its bits unchanged. ``restore`` returns tensors on ``device`` (None:
the card); restoring onto a mesh (``shardings``) waits for ROADMAP A7.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch

from repro_torch.core.range_daat import resolve_device
from repro_torch.models.layers import host_array, is_bf16_bits, tensor_from_numpy

__all__ = ["Checkpointer"]


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if is_bf16_bits(a.dtype) else str(a.dtype)


def _write_member(fid, a: np.ndarray) -> None:
    """``np.lib.format.write_array``, except that bfloat16 bits get the
    header ``ml_dtypes`` gives them (``'<V2'``)."""
    if not is_bf16_bits(a.dtype):
        np.lib.format.write_array(fid, a, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        fid, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
    fid.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8).data)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez``: an uncompressed zip of ``<key>.npy`` members."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_member(fid, a)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep_last = keep_last
        self.host_id = host_id
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, blocking: bool = False):
        flat = _flatten(state)
        host = {k: host_array(v) for k, v in flat.items()}
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(host, step), daemon=True
        )
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, host: dict, step: int):
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        _savez(os.path.join(tmp, f"shard{self.host_id}.npz"), host)
        manifest = {
            "step": step,
            "arrays": {
                k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                for k, v in host.items()
            },
            "n_hosts": 1,
        }
        mtmp = os.path.join(tmp, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(tmp, "manifest.json"))
        os.replace(tmp, path)  # checkpoint becomes visible atomically
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(
                os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True
            )

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, shardings=None, device=None):
        """Restore a step as the reference's tree of tensors on ``device``
        (None: the card); a leaf the manifest calls bfloat16 comes back as
        bfloat16 with its bits unchanged."""
        if shardings is not None:
            raise NotImplementedError(
                "restore with shardings re-shards the arrays onto a device mesh (the "
                "reference's elastic restore); the mesh paths are ROADMAP A7")
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        with np.load(os.path.join(path, f"shard{self.host_id}.npz")) as data:
            for k, meta in manifest["arrays"].items():
                a = data[k]
                if meta["dtype"] == "bfloat16":
                    flat[k] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
                else:
                    flat[k] = tensor_from_numpy(a, dev)
        return _unflatten(flat)

    def restore_latest(self, shardings=None, device=None):
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], shardings=shardings, device=device)
