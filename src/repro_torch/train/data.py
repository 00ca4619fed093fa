"""Data pipelines (host-side, deterministic, restart-safe).

* ``TokenStream`` — synthetic-but-structured LM corpus: a Zipf unigram
  stream with Markov bigram mixing so the loss has real signal (the 100M
  end-to-end example trains to visibly decreasing loss).  Sharded by
  (host, step) so every restart resumes exactly (state = step counter only).
* ``ClickStream`` — DIN training batches: user behaviour sequences with a
  planted preference structure (clicked items share categories with the
  history) so AUC is learnable.
* GNN datasets come from graphs/generators.py + graphs/sampler.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0          # restart-safe position

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def next_batch(self) -> dict:
        rng = self._rng(self.step)
        self.step += 1
        B, S, V = self.batch, self.seq_len, self.vocab_size
        # Zipf marginals + deterministic bigram successor (i -> 7i+3 mod V)
        # mixed 50/50: predictable structure a model can learn.
        zipf = rng.zipf(1.3, size=(B, S)).astype(np.int64) % V
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = zipf[:, 0]
        follow = rng.random((B, S)) < 0.5
        for t in range(1, S):
            succ = (7 * toks[:, t - 1] + 3) % V
            toks[:, t] = np.where(follow[:, t], succ, zipf[:, t])
        tokens = toks.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])


@dataclasses.dataclass
class ClickStream:
    n_items: int
    n_cates: int
    batch: int
    seq_len: int = 100
    seed: int = 0
    step: int = 0

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        B, S = self.batch, self.seq_len
        cate_of = lambda item: item % self.n_cates
        # histories cluster in a per-user band of categories so that
        # category-presence carries signal even with few categories
        band = rng.integers(0, self.n_cates, B)
        width = max(self.n_cates // 8, 1)
        hist_c = (band[:, None] + rng.integers(0, width, (B, S))) % self.n_cates
        hist = hist_c + self.n_cates * rng.integers(
            0, max(self.n_items // self.n_cates, 1), (B, S))
        hist_len = rng.integers(S // 4, S + 1, B)
        mask = np.arange(S)[None, :] < hist_len[:, None]
        # positives share the user's category band; negatives are drawn
        # from outside it (hard label structure the model can learn)
        pos = rng.random(B) < 0.5
        pos_c = (band + rng.integers(0, width, B)) % self.n_cates
        neg_c = (band + width + rng.integers(
            0, max(self.n_cates - width, 1), B)) % self.n_cates
        tc = np.where(pos, pos_c, neg_c)
        target = tc + self.n_cates * rng.integers(
            0, max(self.n_items // self.n_cates, 1), B)
        return {
            "target_item": target.astype(np.int32),
            "target_cate": cate_of(target).astype(np.int32),
            "hist_items": hist.astype(np.int32),
            "hist_cates": cate_of(hist).astype(np.int32),
            "hist_mask": mask,
            "labels": pos.astype(np.float32),
        }

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
