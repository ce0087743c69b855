"""Int8 error-feedback gradient compression, the single-device half.

The counterpart of the JAX package's ``optim/compression.py``: the block
quantizer (block 256, absmax scale, round half to even) and the error
buffers. ``compress_psum_pod`` exchanges the int8 payloads over a mesh's
pod axis (``shard_map`` and ``all_gather`` in the reference); it raises
until the mesh paths are ported (ROADMAP A7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import param_leaves

__all__ = ["compress_psum_pod", "init_error_buffers"]

_BLOCK = 256


def _quantize(x: torch.Tensor):
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _dequantize(q, scale, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def init_error_buffers(params_like, n_pods: int, device=None):
    """Per-pod float32 error state, leading dim = n_pods, by parameter name
    (``params_like`` a ``Params`` tree), on its device unless given."""
    return {n: torch.zeros((n_pods, *p.shape), dtype=torch.float32,
                           device=p.device if device is None else device)
            for n, p in param_leaves(params_like).items()}


def compress_psum_pod(grad_fn, mesh, pod_axis: str = "pod"):
    raise NotImplementedError(
        "compress_psum_pod exchanges int8 gradients over a mesh's pod axis "
        "(shard_map and all_gather in the reference); the mesh paths are ROADMAP A7")
