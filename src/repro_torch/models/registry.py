"""Model registry: config -> model instance + declared serving capabilities.

``serving_caps(cfg)`` declares what the serving stack may do with a family;
the engine and the ``serve/state.py`` adapters consult these flags instead
of inspecting model methods.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import mamba2, transformer, whisper, xlstm
from repro_torch.models.mamba2 import Zamba2
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.whisper import Whisper
from repro_torch.models.xlstm import XLSTM


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


def build_model(cfg: ModelConfig, mesh=None, **kw):
    """The model for ``cfg``'s family: ``DecoderLM`` (dense, MoE, VLM),
    ``XLSTM`` (ssm), ``Zamba2`` (hybrid) or ``Whisper`` (audio). ``mesh``
    (an abstract mesh or a DeviceMesh) and ``shd_rules`` set the model's
    ``Sharder``; ``moe_impl="shard_map"`` runs expert parallelism."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, mesh, **kw)
    if cfg.family == "ssm":
        return XLSTM(cfg, mesh, **kw)
    if cfg.family == "hybrid":
        return Zamba2(cfg, mesh, **kw)
    if cfg.family == "audio":
        return Whisper(cfg, mesh, **kw)
    raise ValueError(f"unknown family {cfg.family}")


_SHAPES = {DecoderLM: transformer.param_shapes, XLSTM: xlstm.param_shapes,
           Zamba2: mamba2.param_shapes, Whisper: whisper.param_shapes}


def abstract_params(model):
    """(shape tree, logical-axes tree) of ``model``'s parameters, without
    allocation: the ``param_specs`` input."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree[0])
    return shapes(_SHAPES[type(model)](model.cfg)), model.param_axes()


def token_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The train or prefill batch of ``shape`` for this arch as meta
    tensors (the reference's ShapeDtypeStructs, in its dtypes): int32
    ``tokens`` (and ``labels`` to train), bf16 ``frames`` for audio and
    bf16 ``patch_embeddings`` for the VLM."""
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta)}
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.bfloat16, **meta)
    if cfg.family == "vlm":
        batch["patch_embeddings"] = torch.empty(
            (b, cfg.stub_prefix_len, cfg.d_model), dtype=torch.bfloat16,
            **meta)
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, **meta)
    return batch
