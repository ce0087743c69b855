"""Int8 error-feedback gradient compression for the cross-pod reduction.

The counterpart of the JAX package's ``optim/compression.py``: the block
quantizer (block 256, absmax scale, round half to even), the error
buffers, and ``compress_psum_pod``, which exchanges int8 block-quantized
gradients over a mesh's ``pod`` axis (an ``all_gather`` of the int8
payloads and the float32 block scales, then a local dequantise and sum)
instead of a float32 all-reduce, and keeps each pod's quantization error
to re-inject it at the next step (error feedback). Error buffers carry a
leading pod dim.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P, all_gather, axis_size, shard_map
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
    """Wrap a per-pod gradient fn with int8 EF compression over ``pod``.

    grad_fn(batch_shard) -> per-pod gradients (a dict of tensors; the
    parameters are closed over). Returns fn(batch, err) -> (mean gradients
    across pods, new error buffers), every rank calling it with the global
    batch and error buffers (a dict of [n_pods, ...] tensors), as the
    mesh's ``shard_map`` takes them; each rank gets the global results.
    """

    def body(batch_shard, err):
        g = grad_fn(batch_shard)
        n_pods = axis_size(pod_axis)
        grads, new_err = {}, {}
        for name, gl in g.items():
            gf = gl.to(torch.float32) + err[name][0]  # leading pod dim -> local slice
            q, scale = _quantize(gf)
            # Compressed exchange: int8 payload + float32 block scales.
            q_all = all_gather(q, pod_axis)  # [P, blocks, 256] int8
            s_all = all_gather(scale, pod_axis)
            summed = torch.sum(q_all.to(torch.float32) * s_all, dim=0).reshape(-1)[
                : gf.numel()].reshape(gf.shape)
            grads[name] = summed / n_pods
            new_err[name] = (gf - _dequantize(q, scale, gf.shape))[None]
        return grads, new_err

    return shard_map(body, mesh=mesh, in_specs=(P(pod_axis), P(pod_axis)),
                     out_specs=(P(), P(pod_axis)))
