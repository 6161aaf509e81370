"""Model registry: config -> model instance + declared serving capabilities.

``serving_caps(cfg)`` declares what the serving stack may do with a family;
the engine and the ``serve/state.py`` adapters consult these flags instead
of inspecting model methods.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM


@dataclasses.dataclass(frozen=True)
class ServingCaps:
    """Declared serving capabilities for one model family.

    ``kind`` names the ``CacheAdapter`` backend that owns per-slot state:
    ``paged-kv`` (flat (k, v) layer caches behind a refcounted PagePool),
    ``window-ring`` (gemma3 local:global ring caches, contiguous slots), or
    ``recurrent`` (carried state gather/scatter/reset + chunked prefill).
    """

    family: str
    kind: str                      # paged-kv | window-ring | recurrent
    bucketed_prefill: bool         # right-pad to pow2 bucket + true_len mask
    paged_kv: bool                 # PagePool block indirection
    prefix_cache: bool             # radix trie sharing (requires paged_kv)
    chunked_prefill: bool          # left-to-right start_pos chunk resume
    needs_frames: bool = False     # audio: requests carry encoder frames


def serving_caps(cfg: ModelConfig) -> ServingCaps:
    """Declared capability flags for ``cfg``'s family (no model needed)."""
    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.local_global_period > 0:
            return ServingCaps(cfg.family, "window-ring",
                               bucketed_prefill=True, paged_kv=False,
                               prefix_cache=False, chunked_prefill=False)
        return ServingCaps(cfg.family, "paged-kv",
                           bucketed_prefill=True, paged_kv=True,
                           prefix_cache=True, chunked_prefill=True)
    if cfg.family in ("ssm", "hybrid"):
        return ServingCaps(cfg.family, "recurrent",
                           bucketed_prefill=False, paged_kv=False,
                           prefix_cache=False, chunked_prefill=True)
    if cfg.family == "audio":
        return ServingCaps(cfg.family, "recurrent",
                           bucketed_prefill=False, paged_kv=False,
                           prefix_cache=False, chunked_prefill=True,
                           needs_frames=True)
    raise ValueError(f"unknown family {cfg.family}")


def build_model(cfg: ModelConfig, **kw):
    """The model for ``cfg``: the dense family in this slice; the others
    raise until their slice ports them."""
    if cfg.family == "dense":
        return DecoderLM(cfg, **kw)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (MoE/VLM and the "
        "recurrent families are later slices of the port)")
