"""Deterministic synthetic C4-like token pipeline, copied from
``repro.data.pipeline`` (pure numpy): the same seed and cursor give
bit-identical batches in both packages.

Offline container ⇒ no HuggingFace C4; we build a *learnable* surrogate: a
seeded order-1 Markov source with low-rank transition structure, packed
into fixed-length sequences exactly like a real pretraining pipeline (doc
boundaries marked with EOS, no padding waste).

Properties the framework relies on:
  * deterministic in (seed, host_id, num_hosts, step) — restart-safe, and
    the *global* batch is identical for any host count (elasticity),
  * host-sharded: each host generates only its slice of the global batch,
  * checkpointable: ``state_dict()``/``restore()`` round-trips the cursor,
  * cheap: the Markov walk is vectorized across the batch; per step cost is
    O(seq · batch) table lookups (the transition top-k table is precomputed
    once a process for each (vocab, seed)).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

_TOPK = 32          # sampled support per transition row
_MAX_STATES = 4096  # Markov states = min(vocab, this); token -> state by mod


@dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict[str, int]:
        return {"seed": int(self.seed), "step": int(self.step)}

    @staticmethod
    def from_dict(d) -> "DataState":
        return DataState(int(d["seed"]), int(d["step"]))


@functools.lru_cache(maxsize=8)
def _transition_table(vocab_size: int, seed: int):
    """(ids, cdf, n_states): the top-k transition table of ``seed``'s
    source over ``vocab_size`` tokens, read-only. Computed once a process
    for each (vocab, seed) and shared by every source built on it: at a
    256 K vocabulary it is seconds of numpy, and a run that builds several
    trainers on one model would otherwise redo it for each."""
    rng = np.random.default_rng(np.uint64(seed))
    r = 16
    n_states = min(vocab_size, _MAX_STATES)
    U = rng.standard_normal((n_states, r)).astype(np.float32)
    V = rng.standard_normal((r, vocab_size)).astype(np.float32)
    bias = (rng.standard_normal((vocab_size,)) * 0.5).astype(np.float32)
    ids = np.empty((n_states, _TOPK), dtype=np.int32)
    cdf = np.empty((n_states, _TOPK), dtype=np.float32)
    for lo in range(0, n_states, 512):
        hi = min(lo + 512, n_states)
        logits = U[lo:hi] @ V + bias            # (chunk, vocab)
        top = np.argpartition(logits, -_TOPK, axis=1)[:, -_TOPK:]
        lt = np.take_along_axis(logits, top, axis=1) / 1.2
        p = np.exp(lt - lt.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        ids[lo:hi] = top.astype(np.int32)
        cdf[lo:hi] = np.cumsum(p, axis=1)
    cdf[:, -1] = 1.0 + 1e-6
    ids.setflags(write=False)
    cdf.setflags(write=False)
    return ids, cdf, n_states


class SyntheticC4:
    """Markov-chain token source with document packing.

    The transition matrix is low-rank (rank 16) so that a small LM can
    actually *learn* it — examples/quickstart.py shows the loss dropping
    well below the unigram entropy.
    """

    EOS = 1

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 42, host_id: int = 0, num_hosts: int = 1,
                 mean_doc_len: int = 192):
        if global_batch % num_hosts:
            raise ValueError("global batch must shard by host")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.mean_doc_len = mean_doc_len
        self.state = DataState(seed=seed, step=0)

        self._ids, self._cdf, self._n_states = _transition_table(
            vocab_size, seed)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return self.state.to_dict()

    def restore(self, d) -> None:
        st = DataState.from_dict(d)
        if st.seed != self.state.seed:
            raise ValueError("restoring a different data seed")
        self.state = st

    def skip(self, n: int) -> None:
        """Advance the cursor ``n`` batches without generating them —
        the trainer's divergence rollback resumes from the checkpoint but
        takes a DIFFERENT data path past the batch that blew up."""
        self.state = DataState(self.state.seed, self.state.step + int(n))

    # -- generation ----------------------------------------------------------
    def _global_rows(self, rng: np.random.Generator, n_rows: int) -> np.ndarray:
        """Vectorized Markov walk: all rows advance one position per loop
        iteration; doc boundaries are per-row countdowns emitting EOS."""
        s, b = self.seq_len, n_rows
        out = np.empty((b, s), dtype=np.int32)
        tok = rng.integers(3, self.vocab_size, size=b).astype(np.int32)
        remain = np.maximum(8, rng.exponential(self.mean_doc_len, size=b)
                            ).astype(np.int64)
        u = rng.random((s, b), dtype=np.float32)
        u_new = rng.integers(3, self.vocab_size, size=(s, b)).astype(np.int32)
        for i in range(s):
            at_eos = remain <= 0
            tok = np.where(at_eos, self.EOS, tok)
            out[:, i] = tok
            # next token: sample from the state's top-k CDF
            st = tok % self._n_states
            choice = (u[i][:, None] > self._cdf[st]).sum(axis=1)
            nxt = self._ids[st, choice]
            # rows that just emitted EOS start a new doc with a fresh token
            nxt = np.where(at_eos, u_new[i], nxt)
            remain = np.where(at_eos,
                              np.maximum(8, (u[i] * 2 * self.mean_doc_len)
                                         .astype(np.int64)),
                              remain - 1)
            tok = nxt.astype(np.int32)
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        """Local shard of the global batch for this step: {tokens (b, s)}."""
        step = self.state.step
        rng = np.random.default_rng(
            np.uint64(self.state.seed * 1_000_003 + step))
        rows = self._global_rows(rng, self.global_batch)
        lo = self.host_id * self.local_batch
        self.state = DataState(self.state.seed, step + 1)
        return {"tokens": rows[lo:lo + self.local_batch]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def unigram_entropy(vocab_size: int, seed: int = 42, samples: int = 8192) -> float:
    """Empirical unigram cross-entropy of the source — the 'no-learning'
    baseline the quickstart compares against."""
    ds = SyntheticC4(vocab_size, 256, max(1, samples // 256), seed=seed)
    toks = ds.next_batch()["tokens"].reshape(-1)
    counts = np.bincount(toks, minlength=vocab_size).astype(np.float64) + 1e-9
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum())
