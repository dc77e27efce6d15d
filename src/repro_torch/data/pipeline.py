"""Deterministic synthetic data pipeline (the port's copy of
``repro/data/pipeline.py``: plain numpy, no change).

Produces next-token-prediction batches from a seeded PRNG stream with a
Zipfian token distribution (realistic softmax/label statistics), sharded
per data-parallel rank, with background host prefetch.

The pipeline is the same object on 1 chip and 512: each rank draws its own
slice of the global batch from a rank-folded key, so the global batch is
identical regardless of topology (elastic-rescale safe — the paper's
serialized-size trick needs jobs to be resumable at a different width).
Batches are numpy int32 arrays on the host, bitwise the reference's; the
caller moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # token frequency skew
    prefetch: int = 2


class SyntheticLM:
    """Infinite deterministic token stream: batch(step, rank, num_ranks)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        # Zipfian unigram distribution over the vocab (stable across calls).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-data.zipf_a)
        self.probs = probs / probs.sum()

    def batch(self, step: int, rank: int = 0, num_ranks: int = 1) -> dict:
        d, c = self.data, self.cfg
        assert d.global_batch % num_ranks == 0, (d.global_batch, num_ranks)
        per = d.global_batch // num_ranks
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, rank])
        )
        s_text = (
            d.seq_len - c.num_patches if c.family == "vlm" else d.seq_len
        )
        toks = rng.choice(
            c.vocab_size, size=(per, s_text + 1), p=self.probs
        ).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (per, c.num_patches, c.d_model), dtype=np.float32
            ).astype(np.dtype(c.dtype) if c.dtype != "bfloat16" else np.float32)
        if c.family == "encdec":
            out["frame_embeds"] = rng.standard_normal(
                (per, c.num_frames, c.d_model), dtype=np.float32
            )
        return out


class Prefetcher:
    """Background-thread host prefetch (overlaps batch synthesis/IO with
    device compute)."""

    def __init__(self, source: SyntheticLM, rank: int = 0, num_ranks: int = 1,
                 start_step: int = 0, depth: int | None = None):
        self.source = source
        self.rank, self.num_ranks = rank, num_ranks
        self._q: queue.Queue = queue.Queue(
            maxsize=depth or source.data.prefetch
        )
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        while not self._stop.is_set():
            b = self.source.batch(self._step, self.rank, self.num_ranks)
            self._q.put((self._step, b))
            self._step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
