"""Deterministic, shardable synthetic token pipeline.

Properties needed at 1000+ nodes (DESIGN.md §5):
  * **deterministic indexing** — batch content is a pure function of
    (step, host_index), so restarts and elastic rescales never double-feed
    or skip data: after restoring step S from a checkpoint, every host
    regenerates exactly the batch it would have seen;
  * **host-local generation** — each host materialises only its shard of
    the global batch (global_batch // data_shards rows);
  * **resumable iterator state** — the state is just the integer step.

The "dataset" is a seeded PRNG token stream (documents of geometric length
with BOS/EOS framing) — the framework's real-data entry point is
``TokenSource``, which any tokenised corpus can implement.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol

import numpy as np


class TokenSource(Protocol):
    def batch(self, step: int, shard: int, nshards: int,
              batch_size: int, seq_len: int) -> np.ndarray: ...


@dataclasses.dataclass(frozen=True)
class SyntheticLM(TokenSource):
    """Seeded synthetic documents; vocabulary ``vocab``."""

    vocab: int
    seed: int = 0
    bos: int = 1
    eos: int = 2
    mean_doc_len: int = 512

    def batch(self, step: int, shard: int, nshards: int,
              batch_size: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch_size, seq_len + 1), np.int32)
        for row in range(batch_size):
            # deterministic per (step, global_row): elastic-rescale safe
            global_row = step * batch_size * nshards + shard * batch_size \
                + row
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, global_row]))
            toks: list[int] = []
            while len(toks) < seq_len + 1:
                n = int(rng.geometric(1.0 / self.mean_doc_len))
                toks.append(self.bos)
                toks.extend(rng.integers(3, self.vocab,
                                         size=min(n, seq_len + 1)).tolist())
                toks.append(self.eos)
            out[row] = toks[:seq_len + 1]
        return out


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    data_shards: int = 1


class Pipeline:
    """Per-host iterator yielding {'tokens', 'labels'} numpy batches."""

    def __init__(self, source: TokenSource, cfg: DataConfig, shard: int = 0,
                 start_step: int = 0):
        if cfg.global_batch % cfg.data_shards:
            raise ValueError("global_batch must divide by data_shards")
        self.source = source
        self.cfg = cfg
        self.shard = shard
        self.step = start_step

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.data_shards

    def next(self) -> dict[str, np.ndarray]:
        seq = self.source.batch(self.step, self.shard,
                                self.cfg.data_shards, self.local_batch,
                                self.cfg.seq_len)
        self.step += 1
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # -- state for checkpointing -----------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "shard": self.shard}

    def restore(self, state: dict, new_shard: int | None = None,
                new_nshards: int | None = None) -> None:
        """Resume; optionally re-shard for elastic rescale.  Determinism of
        ``batch(step, shard, nshards, ...)`` guarantees exactly-once
        consumption across the reshard boundary."""
        self.step = int(state["step"])
        if new_shard is not None:
            self.shard = new_shard
        if new_nshards is not None:
            self.cfg = dataclasses.replace(self.cfg,
                                           data_shards=new_nshards)
