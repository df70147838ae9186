"""Deterministic synthetic LM token stream, the port's own copy of
``repro/data/lm_pipeline.py::TokenStream`` (numpy only).

Batch ``i`` is a pure function of ``(seed, i, host)``: a Zipf-ish (alpha
1.1) frequency-ranked token source in which about every other token
echoes the previous one shifted by a seeded constant. The front-end
stubs' inputs come from the same generator, after the tokens: the vision
stub's ``patch_embeds`` (the tokens cut to ``S - n_frontend_tokens``) and
the encoder-decoder's ``frames``. The batches equal the reference's bit
for bit.
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
        S)`` int32 each; for the vision stub also ``patch_embeds (B, Np,
        D)`` f32 and the text cut to ``S - Np``; for an encoder-decoder
        also ``frames (B, n_frontend_tokens, D)`` f32."""
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
        out = {"tokens": tokens[:, :-1].astype(np.int32),
               "labels": tokens[:, 1:].astype(np.int32)}
        cfg = self.cfg
        if cfg.frontend == "vision_stub":
            npz = cfg.n_frontend_tokens
            out["patch_embeds"] = rng.standard_normal(
                (B, npz, cfg.d_model)).astype(np.float32) * 0.02
            out["tokens"] = out["tokens"][:, :S - npz]
            out["labels"] = out["labels"][:, :S - npz]
        if cfg.is_encoder_decoder:
            out["frames"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


__all__ = ["TokenStream"]
