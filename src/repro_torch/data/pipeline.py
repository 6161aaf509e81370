"""Deterministic, prefetching data pipeline.

Synthetic token streams (seeded, reproducible across restarts by step index —
required for checkpoint-restart determinism), the reference's batches bit
for bit. Batches are produced on the host and placed on a device; a
background thread prefetches ``prefetch`` batches ahead.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import to_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    # synthetic structure: repeated n-grams so the model has learnable signal
    ngram: int = 8


class SyntheticTokens:
    """Step-indexed batches: batch(i) is a pure function of (seed, i)."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # n-gram markov-ish stream: learnable structure, not pure noise
        base = rng.integers(0, v, (b, s // cfg.ngram + 2, 1))
        grams = (base + np.arange(cfg.ngram)[None, None, :]) % v
        tokens = grams.reshape(b, -1)[:, :s].astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1  # ignore last position
        out = {"tokens": tokens, "labels": labels}
        mc = self.model_cfg
        if mc is not None and mc.family == "audio":
            out["frames"] = rng.standard_normal(
                (b, mc.enc_seq, mc.d_model)).astype(np.float32)
        if mc is not None and mc.family == "vlm":
            out["patch_embeddings"] = rng.standard_normal(
                (b, mc.stub_prefix_len, mc.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def batch_to_device(batch: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """A host batch's copy on ``device``, issued without a host sync (one
    would land beside the train loop's one designed sync a step)."""
    return {k: to_device(x, device) for k, x in batch.items()}


class Prefetcher:
    """Background-thread prefetch + device placement (``device`` None keeps
    the host's numpy batches)."""

    def __init__(self, source, start_step: int = 0, prefetch: int = 2,
                 device=None):
        self.source = source
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = self._step
        while not self._stop.is_set():
            batch = self.source.batch(i)
            if self.device is not None:
                batch = batch_to_device(batch, self.device)
            try:
                self._q.put((i, batch), timeout=1.0)
                i += 1
            except queue.Full:
                continue

    def next(self):
        i, batch = self._q.get()
        return i, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def for_cell(model_cfg: ModelConfig, shape: ShapeConfig, seed=0) -> SyntheticTokens:
    return SyntheticTokens(
        DataConfig(seed=seed, vocab_size=model_cfg.vocab_size,
                   seq_len=shape.seq_len, global_batch=shape.global_batch),
        model_cfg)
