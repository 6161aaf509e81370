"""Roofline model for one NVIDIA H100 SXM: three terms from the dry-run's
count (the reference's ``repro.perf.roofline``, on the port's constants).

    compute term    = counted FLOPs / (peak FLOP/s per card)
    memory term     = counted bytes / (HBM bandwidth per card)
    collective term = nvlink_bytes / NVLink bandwidth + net_bytes / network
                      bandwidth

All quantities are per rank (the dry-run counts one rank's step). The
dominant term is the bottleneck; model FLOPs / counted FLOPs measures how
much of the counted compute is "useful" (catches remat and replicated
compute). The constants are ``core.hw``'s: ``H100_SXM`` (989 TFLOP/s bf16,
3.35 TB/s), ``H100_NVLINK_BW`` for the reference's ICI term (a host's
all-to-all NVLink) and ``H100_NET_BW`` for its DCN term (across hosts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.hw import H100_NET_BW, H100_NVLINK_BW, H100_SXM

PEAK_FLOPS_BF16 = H100_SXM.peak_flops     # FLOP/s
HBM_BW = H100_SXM.mem_bw                  # B/s
NVLINK_BW = H100_NVLINK_BW                # B/s per card within a host
NET_BW = H100_NET_BW                      # B/s per card across hosts


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float

    def to_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg, shape, n_params_active: float) -> float:
    """6·N·D for training; 2·N·D for inference (per forward token)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params_active * tokens


def count_params(params_sds) -> float:
    """Elements of a parameter tree: ``abstract_params``' shape tuples, or
    anything with a ``shape``."""
    if isinstance(params_sds, dict):
        return float(sum(count_params(v) for v in params_sds.values()))
    shape = params_sds.shape if hasattr(params_sds, "shape") else params_sds
    return float(math.prod(shape))


def active_params(cfg, n_total: float) -> float:
    """MoE: only top-k + shared experts are active per token."""
    if not cfg.is_moe:
        return n_total
    routed_per_layer = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts
    n_moe_layers = cfg.num_layers - cfg.first_k_dense
    inactive = routed_per_layer * n_moe_layers * (
        1 - cfg.experts_per_token / cfg.num_experts)
    return n_total - inactive


def compute_roofline(analysis: Dict, n_chips: int,
                     model_fl: float) -> Roofline:
    """The three terms of one rank's step from ``step_analysis.analyze``'s
    record (``flops``, ``bytes_accessed``, ``collectives``)."""
    flops = analysis["flops"]
    coll = analysis["collectives"]
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = analysis["bytes_accessed"] / HBM_BW
    collective_s = (coll.get("ici_bytes", 0.0) / NVLINK_BW
                    + coll.get("dcn_bytes", 0.0) / NET_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_fl / n_chips / flops if flops else 0.0
    return Roofline(compute_s, memory_s, collective_s, dominant,
                    model_fl, flops, useful)
