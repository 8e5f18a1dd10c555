"""Synthetic token stream for LM training (a numpy-only copy of
``repro.data.tokens``; no corpora).

Zipf-distributed unigrams composed with a first-order Markov structure so
the loss has learnable signal; deterministic per (seed, step) so restart
recovery can assert bit-exact data-order resumption.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    markov_states: int = 64
    seed: int = 0


class TokenStream:
    """Deterministic synthetic next-token data, shardable by host."""

    def __init__(self, cfg: TokenStreamConfig, host_id: int = 0,
                 n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        assert cfg.global_batch % n_hosts == 0
        self.local_batch = cfg.global_batch // n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Markov chain over latent states; each state emits a Zipf slice
        self._trans = rng.dirichlet(np.ones(cfg.markov_states) * 0.2,
                                    size=cfg.markov_states)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        zipf = ranks ** (-cfg.zipf_a)
        self._emit = np.stack([
            np.roll(zipf, rng.integers(0, v)) for _ in
            range(cfg.markov_states)])
        self._emit /= self._emit.sum(axis=1, keepdims=True)

    def batch(self, step: int):
        """(local_batch, seq_len+1) int32 tokens for this host and step."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_id, 0xC0FFEE))
        b, s = self.local_batch, cfg.seq_len + 1
        states = np.zeros((b,), np.int64)
        out = np.empty((b, s), np.int32)
        cum_t = np.cumsum(self._trans, axis=1)
        cum_e = np.cumsum(self._emit, axis=1)
        u_t = rng.random((b, s))
        u_e = rng.random((b, s))
        for t in range(s):
            states = (cum_t[states] < u_t[:, t:t + 1]).sum(axis=1)
            states = np.minimum(states, cfg.markov_states - 1)
            tok = (cum_e[states] < u_e[:, t:t + 1]).sum(axis=1)
            out[:, t] = np.minimum(tok, cfg.vocab_size - 1)
        return out

    def train_pair(self, step: int):
        """(tokens, labels) = (x[:, :-1], x[:, 1:])."""
        x = self.batch(step)
        return x[:, :-1], x[:, 1:]
