"""Deterministic synthetic LM token stream, the port's own copy of
``repro/data/lm_pipeline.py::TokenStream`` (numpy only).

Batch ``i`` is a pure function of ``(seed, i, host)``: a Zipf-ish (alpha
1.1) frequency-ranked token source in which about every other token
echoes the previous one shifted by a seeded constant. The batches equal
the reference's bit for bit. The vision and audio stubs' extra inputs are
not produced (their front ends are not ported).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig


class TokenStream:
    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert batch % num_hosts == 0
        self.cfg = cfg
        self.global_batch = batch
        self.local_batch = batch // num_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        v = cfg.vocab_size
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = ranks ** -1.1
        self._probs /= self._probs.sum()
        self._shift = rng.integers(1, v - 1)

    def batch_at(self, index: int) -> dict:
        """Batch ``index``: ``tokens`` and next-token ``labels``, ``(B,
        S)`` int32 each."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) * 4099 + self.host_id)
        B, S = self.local_batch, self.seq_len
        base = rng.choice(self.cfg.vocab_size, size=(B, S + 1),
                          p=self._probs)
        echo = (base[:, :-1] + self._shift) % self.cfg.vocab_size
        mask = rng.random((B, S)) < 0.5
        seq = base[:, 1:].copy()
        seq[mask] = echo[mask]
        tokens = np.concatenate([base[:, :1], seq], axis=1)
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32)}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


__all__ = ["TokenStream"]
