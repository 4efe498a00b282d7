"""Deterministic, sharded, resumable data pipeline (the ``SyntheticLM``
source and ``with_extras`` of ``repro.data.pipeline``, copied: numpy only,
so both packages draw the same batches bit for bit; the launcher passes the
host's shard explicitly). The JAX package's ``FileSource`` is not ported
yet.

  * ``SyntheticLM`` yields fixed-length token sequences from a stationary
    Zipfian Markov stream (learnable structure — loss decreases measurably,
    unlike uniform noise).
  * batches are DETERMINISTIC functions of (seed, step, shard) — restart at
    step N reproduces exactly the batches a failed run would have seen, which
    is what makes checkpoint/restart bitwise reproducible.
  * host sharding: each data-parallel host pulls only its shard
    (``shard_id``/``num_shards``), the standard multi-host input pattern.
  * ``state()``/``restore()`` round-trips through the checkpoint metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    zipf_a: float = 1.2        # unigram skew
    markov_order: bool = True  # token t depends on t-1 (learnable bigrams)


class SyntheticLM:
    """Zipfian bigram LM stream: next ~ P(.|prev) from a fixed random bigram
    table. A model that learns the table drops loss well below entropy of the
    unigram distribution — giving smoke trainings a real signal."""

    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        self._step = 0
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        V = cfg.vocab_size
        # sparse-ish bigram transition: each token has 8 likely successors
        self.succ = rng.integers(0, V, size=(V, 8))
        ranks = np.arange(1, 9, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.succ_p = p / p.sum()

    def state(self) -> Dict:
        return {"step": self._step, "seed": self.cfg.seed,
                "shard_id": self.cfg.shard_id,
                "num_shards": self.cfg.num_shards}

    def restore(self, state: Dict):
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self._step = int(state["step"])

    def _batch_rng(self, step: int) -> np.random.Generator:
        # deterministic in (seed, step, shard): restartable + host-sharded
        key = (self.cfg.seed * 1_000_003 + step) * 65_537 + self.cfg.shard_id
        return np.random.default_rng(key)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._batch_rng(step)
        B, L, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, L + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        if cfg.markov_order:
            choices = rng.choice(8, size=(B, L), p=self.succ_p)
            for t in range(1, L + 1):
                toks[:, t] = self.succ[toks[:, t - 1], choices[:, t - 1]]
        else:
            toks[:, 1:] = rng.integers(0, V, size=(B, L))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b


def with_extras(source: Iterable[Dict[str, np.ndarray]], cfg
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Wrap a token source with the modality stub its arch requires, as the
    JAX package draws it, from ``default_rng(i * 7919 + 13)`` for the i-th
    batch this wrapper yields: a vlm (``cfg.frontend == "vit_stub"``)
    batch gains ``patches``, (B, frontend_len, frontend_dim) f32 standard
    normals; an enc-dec batch gains ``frames``, (B, L, frontend_dim) f32
    standard normals, one frame a token (so the encoder's length in
    training is the token length, not ``frontend_len``). Other archs'
    batches pass through."""
    for i, batch in enumerate(source):
        rng = np.random.default_rng(i * 7919 + 13)
        if cfg.frontend == "vit_stub":
            batch["patches"] = rng.normal(size=(
                batch["tokens"].shape[0], cfg.frontend_len,
                cfg.frontend_dim)).astype(np.float32)
        if cfg.is_encdec:
            batch["frames"] = rng.normal(size=(
                batch["tokens"].shape[0], batch["tokens"].shape[1],
                cfg.frontend_dim)).astype(np.float32)
        yield batch
