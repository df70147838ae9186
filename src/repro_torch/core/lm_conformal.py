"""Conformal prediction over a language model's embeddings.

Counterpart of ``repro/core/lm_conformal.py``: the mean final hidden state
of a sequence is the object space, and the paper's optimized full-CP
measures run on top of it.

* ``ConformalLmClassifier`` — full k-NN CP over a small label set
  (``core/measures/knn.py``'s fit and optimized p-values);
* ``ConformalOodDetector`` — simplified k-NN CP with a single label, a
  conformal anomaly detector: ``p ~ U[0, 1]`` for in-distribution inputs,
  ``Pr[p <= eps] <= eps`` under exchangeability, small p for requests
  unlike the calibration traffic.

Both run on ``device`` (cuda unless given). ``ConformalLmClassifier.fit``
takes a ``mesh`` (``core.distributed.Mesh``): over more than one device
the calibration rows shard over its row axes and the queries over its
query axis (``distributed.make_knn_pvalues_fn``), as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch._device import BIG, as_tensor, resolve
from repro_torch.core import distributed as dist
from repro_torch.core.measures import knn as knn_m
from repro_torch.core.online import fsum
from repro_torch.kernels import ref
from repro_torch.models import lm


@dataclass
class ConformalLmClassifier:
    """Full k-NN CP over LM embeddings for an ``n_labels``-label task."""

    n_labels: int
    k: int = 15
    device: Any = None
    _state: Any = field(default=None, repr=False)
    _sharded_fn: Any = field(default=None, repr=False)
    _mesh: Any = field(default=None, repr=False)

    def fit(self, embeddings, labels, mesh=None,
            cfg: dist.CpShardingConfig = dist.CpShardingConfig()):
        """O(n^2) training phase (paper Section 3.1), on the mesh's first
        device when a ``mesh`` is given (else on ``device``). A mesh of
        more than one device then shards the state; one device takes the
        plain path, as the reference's does."""
        dev = mesh.flat()[0] if mesh is not None else resolve(self.device)
        self._state = knn_m.fit(as_tensor(embeddings, torch.float32, dev),
                                as_tensor(labels, torch.int32, dev), k=self.k)
        self._mesh, self._sharded_fn = None, None
        if mesh is not None and mesh.size > 1:
            self._mesh = mesh
            self._state = dist.shard_knn_state(self._state, mesh, cfg)
            self._sharded_fn = dist.make_knn_pvalues_fn(
                mesh, k=self.k, simplified=False, n_labels=self.n_labels,
                cfg=cfg)
        return self

    def pvalues(self, query_embeddings) -> torch.Tensor:
        if self._sharded_fn is not None:
            q = as_tensor(query_embeddings, torch.float32,
                          self._mesh.flat()[0])
            return self._sharded_fn(self._state, q)
        q = as_tensor(query_embeddings, torch.float32, self._state.X.device)
        return knn_m.pvalues_optimized(self._state, q, k=self.k,
                                       simplified=False,
                                       n_labels=self.n_labels)

    def prediction_sets(self, query_embeddings, eps: float) -> torch.Tensor:
        return self.pvalues(query_embeddings) > eps


def _dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Euclidean distances ``(m, n)`` in the reference's matrix form:
    ``sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0))`` with an f32 product."""
    d2 = ((A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
          - 2 * (A @ B.T))
    return torch.sqrt(torch.clamp(d2, min=0.0))


@dataclass
class ConformalOodDetector:
    """Simplified k-NN CP anomaly detector over LM embeddings."""

    k: int = 15
    device: Any = None
    _emb: Any = field(default=None, repr=False)
    _best: Any = field(default=None, repr=False)

    def fit(self, embeddings):
        """Each calibration point's ``k`` smallest distances to the others
        (ascending): the ``(n, n)`` f32 distances with ``BIG`` on the
        diagonal, k smallest by value (so ``topk``'s tie order cannot
        change them), sorted."""
        emb = as_tensor(embeddings, torch.float32, resolve(self.device))
        d = _dists(emb, emb)
        d.fill_diagonal_(BIG)
        self._best = torch.sort(torch.topk(d, self.k, largest=False,
                                           sorted=False).values, 1).values
        self._emb = emb
        return self

    def scores(self, query_embeddings):
        """``(alphas (m, n), alpha (m,))``: every calibration point's score
        with the query added (the O(1) update of paper Fig. 1) and the
        query's own score, the sum of its ``k`` smallest distances."""
        q = as_tensor(query_embeddings, torch.float32, self._emb.device)
        d = _dists(q, self._emb)  # (m, n)
        sum_best = fsum(self._best)
        kth = self._best[:, -1]
        alphas = torch.where(d < kth, sum_best - kth + d, sum_best)
        alpha = fsum(torch.topk(d, self.k, largest=False).values)
        return alphas, alpha

    def pvalues(self, query_embeddings) -> torch.Tensor:
        """Exact full-CP p-values ``(#{alpha_i >= alpha} + 1) / (n + 1)``,
        optimized update (paper Fig. 1)."""
        alphas, alpha = self.scores(query_embeddings)
        cnt = (alphas >= alpha[:, None]).sum(1, dtype=torch.int32)
        return ref.div_k(cnt.float() + 1.0, self._emb.shape[0] + 1)


def hidden_states(params, cfg, batch) -> torch.Tensor:
    """Final-norm hidden states ``(B, S, D)`` for embedding extraction:
    the tokens alone through the layer stack, as the reference has it. A
    batch's ``patch_embeds`` and ``frames`` are not read, so an
    encoder-decoder runs its decoder's self-attention stack without the
    encoder and without its learned positions."""
    return lm.hidden_forward(params, cfg, {"tokens": batch["tokens"]})[0]


def sequence_embedding(params, cfg, batch) -> torch.Tensor:
    """Mean hidden state over the tokens ``(B, D)``: the sum accumulates
    in f32 and the mean is cast back to the model's dtype, as ``jnp.mean``
    does on bf16."""
    h = hidden_states(params, cfg, batch)
    return torch.mean(h, dim=1, dtype=torch.float32).to(h.dtype)


__all__ = ["ConformalLmClassifier", "ConformalOodDetector",
           "hidden_states", "sequence_embedding"]
