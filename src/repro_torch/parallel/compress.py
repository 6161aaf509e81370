"""Gradient compression for the slow inter-pod axis (DALEK's 2.5 GbE lesson).

The pod axis carries pure data parallelism; its gradient all-reduce crosses
the slow network between pods. This compresses that reduction: an int8
block-quantized all-reduce with error feedback (the residual of each
step's local quantization is carried into the next, which keeps the
optimizer unbiased in expectation).

The reference (``repro.parallel.compress``) runs the quantize ->
all-reduce(int sum) -> dequantize pipeline under ``shard_map`` over the
``pod`` axis; here it runs on the ``pod`` process group, each rank with
its own partial gradient. As in the reference, a library function: the
train step does not call it. The quantizer is elementwise torch ops, as
it is XLA ops (not a Pallas kernel) in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def _quantize_blockwise(x, block=BLOCK):
    """f32 [N] -> (int8 [N/block, block], scale f32 [N/block, 1]), N
    padded with zeros to a multiple of ``block``."""
    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, (-n) % block))
    xb = xp.reshape(-1, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    # a true division on every device: CUDA divides by a host scalar as a
    # multiplication by its reciprocal, which rounds differently
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale, n):
    return (q.float() * scale).reshape(-1)[:n]


def compressed_psum_pod(grad_flat, group=None):
    """int8 all-reduce over ``group`` (the ``pod`` ranks); returns the f32
    mean gradient.

    The int8 values are requantized against the group's largest scale (a
    small all-reduce with MAX), summed in int32 (exact for <= 2^24/127
    pods) and dequantized with that scale."""
    n = grad_flat.shape[0]
    q, scale = _quantize_blockwise(grad_flat)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    # requantize against the shared scale so integer sums are coherent
    qs = torch.clamp(torch.round(q.float() * scale / scale_max),
                     -127, 127).to(torch.int8)
    summed = qs.to(torch.int32)
    dist.all_reduce(summed, group=group)
    n_pods = grad_flat.new_full((), float(dist.get_world_size(group)))
    return _dequantize(summed, scale_max, n) / n_pods


def _sorted_leaves(tree, prefix=()):
    """(path, leaf) of nested dicts in sorted-key order (``jax.tree``'s
    flattening order, so the blocks of the concatenated vector match the
    reference's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _sorted_leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def compress_grads_over_pod(grads, mesh, error_state=None):
    """Error-feedback int8 compression of the pod-axis reduction.

    grads: nested dict of f32 tensors whose pod-axis reduction has NOT yet
    happened (each rank's partial gradient). error_state: matching tree of
    residuals (None: zeros). ``mesh``: a DeviceMesh with a ``pod`` axis.
    Returns (reduced_grads, new_error_state)."""
    flat_g = _sorted_leaves(grads)
    if error_state is None:
        flat_e = [torch.zeros_like(g) for _, g in flat_g]
    else:
        flat_e = [e for _, e in _sorted_leaves(error_state)]
    vec = torch.cat([g.reshape(-1) + e.reshape(-1)
                     for (_, g), e in zip(flat_g, flat_e)])
    # the local quantization's residual, carried to the next step
    q, scale = _quantize_blockwise(vec)
    new_err = vec - _dequantize(q, scale, vec.shape[0])
    reduced = compressed_psum_pod(vec, mesh.get_group("pod"))
    out_g, out_e, off = {}, {}, 0
    for path, g in flat_g:
        n = g.numel()
        out_g[path] = reduced[off:off + n].reshape(g.shape)
        out_e[path] = new_err[off:off + n].reshape(g.shape)
        off += n
    return _rebuild(grads, out_g), _rebuild(grads, out_e)


def _rebuild(like, by_path, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, by_path, prefix + (k,))
                for k, v in like.items()}
    return by_path[prefix]


def compression_ratio(n_params: int) -> float:
    """Bytes on the wire vs an f32 all-reduce (scales included)."""
    f32_bytes = 4 * n_params
    int8_bytes = n_params + 4 * (n_params // BLOCK + 1)
    return f32_bytes / int8_bytes
