"""Token data pipeline: synthetic corpus -> document packing -> fixed-length
batches with loss masks; deterministic, shardable by (host, n_hosts).

A copy of the reference's `repro.data.pipeline` (pure numpy): the same
seed gives bitwise the same batches in both packages."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    doc_len_mean: float = 180.0
    doc_len_std: float = 0.6     # lognormal sigma
    bos: int = 1
    eos: int = 2


class SyntheticCorpus:
    """Markov-ish synthetic token stream: documents with topic-biased token
    distributions so models can actually reduce loss on it."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def documents(self, rng) -> Iterator[np.ndarray]:
        c = self.cfg
        n_topics = 32
        topic_bias = None
        while True:
            topic = rng.integers(n_topics)
            tr = np.random.default_rng(topic + 7919)
            logits = tr.normal(0, 2.0, c.vocab)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            length = int(np.clip(rng.lognormal(np.log(c.doc_len_mean),
                                               c.doc_len_std), 8, 4 * c.seq_len))
            toks = rng.choice(c.vocab, size=length, p=p)
            yield np.concatenate([[c.bos], toks, [c.eos]]).astype(np.int32)


def packed_batches(cfg: DataConfig, host: int = 0, n_hosts: int = 1
                   ) -> Iterator[dict]:
    """Yields {tokens: (B, L) int32, loss_mask: (B, L) int32} forever.
    Documents are packed back-to-back; loss_mask zeroes padding."""
    rng = np.random.default_rng(cfg.seed * 1000003 + host)
    corpus = SyntheticCorpus(cfg)
    docs = corpus.documents(rng)
    buf = np.zeros(0, np.int32)
    while True:
        tokens = np.zeros((cfg.batch, cfg.seq_len), np.int32)
        mask = np.zeros((cfg.batch, cfg.seq_len), np.int32)
        for b in range(cfg.batch):
            while len(buf) < cfg.seq_len:
                buf = np.concatenate([buf, next(docs)])
            tokens[b] = buf[:cfg.seq_len]
            mask[b] = 1
            buf = buf[cfg.seq_len:]
        yield {"tokens": tokens, "loss_mask": mask}
