"""Deterministic, shard-aware synthetic token pipeline with host prefetch.

Design mirrors a production loader:
  * every (step, global_example_index) maps to a unique counter-mode PRNG
    stream — restart-stable, order-independent, resumable from any step
    (the checkpoint stores only ``step``);
  * each data-parallel host materializes only its shard of the global batch
    (``shard_index`` / ``num_shards``), so no host ever holds the global
    batch — the property that matters at 1000+ nodes;
  * a background thread keeps a small prefetch queue ahead of the training
    loop (overlap host data gen with device compute).

Synthetic text is a structured Markov-ish stream (not iid uniform) so that
cross-entropy actually decreases during the example training runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticTokens:
    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 shard_index: int = 0, num_shards: int = 1, seed: int = 0):
        assert global_batch % num_shards == 0
        self.cfg = cfg
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.shard = shard_index
        self.num_shards = num_shards
        self.seed = seed
        # fixed random "grammar": each token deterministically prefers a
        # successor band — learnable structure for the example runs
        rng = np.random.default_rng(seed ^ 0x5EED)
        self.vocab = min(cfg.vocab, 32_768)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab,),
                                  dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        """The (deterministic) local batch for a global step."""
        B, S = self.local_batch, self.seq
        out = np.empty((B, S + 1), dtype=np.int32)
        for i in range(B):
            g = step * (B * self.num_shards) + self.shard * B + i
            rng = np.random.default_rng((self.seed, g))
            toks = np.empty(S + 1, dtype=np.int64)
            toks[0] = rng.integers(0, self.vocab)
            noise = rng.random(S)
            jumps = rng.integers(0, self.vocab, size=S)
            for t in range(S):
                toks[t + 1] = (self._succ[toks[t]] if noise[t] < 0.8
                               else jumps[t])
            out[i] = toks
        batch = {"tokens": out[:, :-1], "labels": out[:, 1:]}
        if not self.cfg.embed_inputs:                     # audio stub
            rng = np.random.default_rng((self.seed, step, self.shard))
            batch["frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            del batch["tokens"]
        if self.cfg.family == "vlm":
            rng = np.random.default_rng((self.seed, step, self.shard, 7))
            batch["img_embeds"] = rng.standard_normal(
                (B, self.cfg.n_img_tokens, self.cfg.d_model)).astype(np.float32)
        return batch

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[dict]:
        """Prefetching iterator from ``start_step`` (resume point)."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
