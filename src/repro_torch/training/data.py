"""Deterministic, restartable data pipelines (numpy only): a copy of
``repro.training.data``, so that both packages draw the same batches.

Every pipeline is a pure function of (seed, step, host_shard) — no hidden
iterator state — so checkpoint/restart and elastic re-sharding are exact:
the loader's "state" is just the integer step, which is stored in the
checkpoint.  ``host_id``/``n_hosts`` shard the global batch across processes
(one process is n_hosts=1; the sharding logic is unit-tested).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Deterministic token stream: tokens = PRNG(seed, step, position).

    Not i.i.d. noise — a light Markov structure (next token depends on the
    previous token and a per-sequence key) so a model can actually reduce
    loss on it, which the training example and tests rely on.
    """

    def __init__(self, dc: DataConfig, vocab_size: int, family: str = "dense",
                 d_model: int = 0, n_vision_tokens: int = 0):
        self.dc = dc
        self.vocab = vocab_size
        self.family = family
        self.d_model = d_model
        self.n_vision_tokens = n_vision_tokens

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        rng = np.random.RandomState(
            (dc.seed * 1_000_003 + step) % (2**31 - 1))
        # skip rows belonging to other hosts deterministically
        all_tokens = rng.randint(
            0, self.vocab, size=(dc.global_batch, dc.seq_len + 1), dtype=np.int64)
        # Markov-ify: t[i+1] = (t[i] + noise % 17) % vocab — a local additive
        # drift, so a model that attends to the previous token drops from
        # ln(V) to ~ln(17) loss quickly (the learnability contract that
        # tests/examples rely on)
        noise = all_tokens
        tok = np.empty_like(noise)
        tok[:, 0] = noise[:, 0]
        for i in range(1, tok.shape[1]):
            tok[:, i] = (tok[:, i - 1] + noise[:, i] % 17) % self.vocab
        lo = dc.host_id * dc.host_batch
        tok = tok[lo:lo + dc.host_batch]
        batch = {
            "inputs": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32),
        }
        if self.family == "audio":
            frames = rng.standard_normal(
                (dc.global_batch, dc.seq_len, self.d_model)).astype(np.float32)
            batch["inputs"] = frames[lo:lo + dc.host_batch]
            batch["labels"] = batch["labels"]
        if self.family == "vlm":
            vis = rng.standard_normal(
                (dc.global_batch, self.n_vision_tokens, self.d_model)).astype(np.float32)
            batch["vision"] = vis[lo:lo + dc.host_batch]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteCorpus:
    """Byte-level LM over a real text file, deterministic per (seed, step).

    The file is mapped once; batches are fixed-length windows at positions
    drawn from a per-step PRNG, sharded across hosts by interleaving.
    """

    def __init__(self, dc: DataConfig, path: str, vocab_size: int = 256):
        self.dc = dc
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        assert len(self.data) > dc.seq_len + 2, "corpus too small"
        self.vocab = vocab_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        rng = np.random.RandomState((dc.seed * 7_368_787 + step) % (2**31 - 1))
        starts = rng.randint(0, len(self.data) - dc.seq_len - 1,
                             size=(dc.global_batch,))
        lo = dc.host_id * dc.host_batch
        starts = starts[lo:lo + dc.host_batch]
        tok = np.stack([self.data[s:s + dc.seq_len + 1] for s in starts]).astype(np.int32)
        return {"inputs": tok[:, :-1] % self.vocab,
                "labels": tok[:, 1:] % self.vocab}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(cfg: ModelConfig, dc: DataConfig, corpus_path: Optional[str] = None):
    if corpus_path:
        return ByteCorpus(dc, corpus_path, vocab_size=min(cfg.vocab_size, 256))
    return SyntheticLM(dc, cfg.vocab_size, family=cfg.family,
                       d_model=cfg.d_model, n_vision_tokens=cfg.n_vision_tokens)
