"""Batched serving engine: prefill + greedy decode.  Port of
``repro/serve/engine.py`` on one device (no mesh, no ``serve_shardings``).

The engine is step-synchronous: one ``decode_step`` per token over the
whole batch.  Prompts are right-aligned on token 0, as in the JAX package.
Each step's next tokens are copied to the host once for the whole batch
(asynchronously into pinned memory on the card), never once per request.
Everything runs under ``torch.inference_mode()``.  After each call,
``Engine.stats`` holds the prefill's and the decode loop's milliseconds
(CUDA events on the card, the host clock on the CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import lm


def make_prefill(cfg: ModelConfig, max_len: int):
    def prefill(params, batch):
        return lm.prefill(cfg, params, batch, max_len)
    return prefill


def make_serve_step(cfg: ModelConfig, greedy: bool = True):
    """(params, cache, batch) → (next_token (B,1) int32, logits, cache)."""
    def step(params, cache, batch):
        logits, cache = lm.decode_step(cfg, params, cache, batch)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return step


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    out: Optional[np.ndarray] = None


class _Marks:
    """Timestamps that do not synchronise: CUDA events on the card, the
    host clock elsewhere; read with ``ms`` after the device has finished."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Engine:
    """Batched greedy engine.  ``device=None`` means the CUDA device (and
    raises without one); the params are moved there if they are not."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.max_len = cfg, max_len
        self.params = lm.tree_to(params, self.device)
        self._prefill = make_prefill(cfg, max_len)
        self._step = make_serve_step(cfg)
        self.stats: dict = {}

    def generate(self, requests: List[Request], forced=None,
                 return_logits: bool = False):
        """Greedy continuations into each request's ``out``.  ``forced``
        (B, n_steps) feeds those tokens instead of the argmax (teacher
        forcing; ``out`` then holds them).  With ``return_logits`` it also
        returns the f32 logits (n_steps + 1, B, V): the prefill's, then each
        decode step's."""
        B = len(requests)
        S = max(len(r.prompt) for r in requests)
        n_steps = max(r.max_new_tokens for r in requests)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(requests):                 # right-aligned
            toks[i, S - len(r.prompt):] = r.prompt
        on_card = self.device.type == "cuda"
        host = torch.empty((n_steps, B), dtype=torch.int32,
                           pin_memory=on_card)
        kept = []
        marks = _Marks(self.device)
        with torch.inference_mode():
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            marks.mark()
            logits, cache = self._prefill(self.params, batch)
            marks.mark()
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            if forced is not None:
                forced = torch.as_tensor(np.asarray(forced, np.int32),
                                         device=self.device)
            for t in range(n_steps):
                if return_logits:
                    kept.append(logits)
                if forced is not None:
                    nxt = forced[:, t:t + 1]
                host[t].copy_(nxt[:, 0], non_blocking=on_card)
                nxt, logits, cache = self._step(self.params, cache,
                                                {"tokens": nxt})
            marks.mark()
            if return_logits:
                kept.append(logits)
                kept = torch.stack(kept).cpu().numpy()
        if on_card:
            torch.cuda.current_stream(self.device).synchronize()
        self.stats = {"prefill_ms": marks.ms(0, 1),
                      "decode_ms": marks.ms(1, 2), "steps": n_steps,
                      "batch": B, "prompt_len": S}
        outs = host.numpy().T
        for i, r in enumerate(requests):
            r.out = np.array(outs[i, :r.max_new_tokens], np.int32)
        return (requests, kept) if return_logits else requests
