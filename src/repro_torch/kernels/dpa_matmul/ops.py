"""Counted entry points for the dpa_matmul kernel, and the int8 quantized
linear built on its ``dpa4`` variant.

The quantized linear (per-output-channel symmetric int8 weights, dynamic
per-token int8 activations) is the energy-oriented compute path: DPA4
doubles op/s over DPA2 on every DALEK CPU (paper Fig. 5), and the H100's
int8 tensor-core rate is twice its bf16 rate too.
"""
import torch

from repro_torch.core.tracing import TraceStats, counting_call
from repro_torch.kernels.dpa_matmul.dpa_matmul import dpa_matmul

#: module-level compile accounting for the counted entry points
stats = TraceStats()


def _matmul(a, b, variant="dpa2"):
    return dpa_matmul(a, b, variant=variant)


matmul = counting_call(_matmul, "dpa/matmul", stats)


def quantize_int8(x, axis):
    """Symmetric int8 quantization along ``axis``. Returns (q, scale):
    scale = amax/127 where amax > 0, else 1; q = round-half-even(x/scale)
    clipped to [-127, 127]."""
    amax = x.float().abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantized_linear(x, w):
    """x: [M,K] fp; w: [K,N] fp -> [M,N] f32 via the int8 DPA4 kernel."""
    xq, xs = quantize_int8(x, axis=1)          # per-token
    wq, ws = quantize_int8(w, axis=0)          # per-out-channel
    acc = dpa_matmul(xq, wq, variant="dpa4")
    return acc.float() * xs * ws


quantized_linear = counting_call(_quantized_linear, "dpa/quantized_linear",
                                 stats)
