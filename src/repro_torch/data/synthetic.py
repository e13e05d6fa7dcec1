"""Deterministic synthetic LM data with learnable structure (the port's
copy of ``repro.data.synthetic``).

A seeded "Zipf-Markov" language: marginals are Zipf-distributed (like real
token frequencies) and each token has a deterministic affine successor that
fires with probability ``p_rule``.  A model that trains on this stream has
real signal to learn (successor rule + marginals), so held-out perplexity is
a quality proxy for the LExI-vs-pruning comparison.

Everything is a pure function of (seed, host, step), drawn with numpy
(never torch's generator): restart-deterministic and shardable across hosts
without coordination.  ``sample_batch`` draws the same tokens as the
reference's algorithm, kept verbatim as ``sample_batch_plain``.

For an encoder-decoder (``data_config_for`` of whisper) each batch also
carries stub ``frames`` [B, frame_len, d_model], standard normal f32 from
a generator of their own, so the token stream is the reference's either
way (the reference's stream has no frames: its loop cannot train one).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_rule: float = 0.7         # successor-rule firing probability
    zipf_a: float = 1.2         # Zipf exponent
    num_hosts: int = 1
    host_id: int = 0
    #: stub encoder frames a row (an encoder-decoder's encoder_seq_len x
    #: d_model); 0: no frames
    frame_len: int = 0
    d_model: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


def _zipf_probs(v: int, a: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, v + 1), a)
    return p / p.sum()


@lru_cache(maxsize=8)
def _zipf_cdf(v: int, a: float) -> np.ndarray:
    """The CDF ``Generator.choice(v, p=probs)`` rebuilds on every call (the
    cumulative sum, divided by its last entry); read-only, as it is shared."""
    cdf = _zipf_probs(v, a).cumsum()
    cdf /= cdf[-1]
    cdf.setflags(write=False)
    return cdf


def _successor(tokens: np.ndarray, v: int) -> np.ndarray:
    return (tokens * 31 + 17) % v


def _rng(dc: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([dc.seed, dc.host_id, step]))


def _batch(seq: np.ndarray) -> Dict[str, np.ndarray]:
    b, s = seq.shape[0], seq.shape[1] - 1
    return {
        "tokens": seq[:, :-1].astype(np.int32),
        "targets": seq[:, 1:].astype(np.int32),
        "mask": np.ones((b, s), np.int32),
    }


def sample_batch_plain(dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The reference's algorithm: ``rng.choice`` at every position."""
    rng = _rng(dc, step)
    b, s, v = dc.local_batch, dc.seq_len, dc.vocab_size
    probs = _zipf_probs(v, dc.zipf_a)
    seq = np.empty((b, s + 1), np.int64)
    seq[:, 0] = rng.choice(v, size=b, p=probs)
    for t in range(1, s + 1):
        rule = rng.random(b) < dc.p_rule
        zipf = rng.choice(v, size=b, p=probs)
        seq[:, t] = np.where(rule, _successor(seq[:, t - 1], v), zipf)
    return _batch(seq)


def sample_batch(dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for (host, step): tokens / targets / mask [B_local, S], and
    ``frames`` when ``dc.frame_len`` is set.

    The same draws as ``sample_batch_plain``: ``choice`` with ``p`` maps
    one uniform double through the CDF, and the generator hands doubles
    out in order, so the uniforms of every position are drawn in one call
    (first-token draws, then per position the rule's and the Zipf draw's)
    and the CDF is built once."""
    rng = _rng(dc, step)
    b, s, v = dc.local_batch, dc.seq_len, dc.vocab_size
    cdf = _zipf_cdf(v, dc.zipf_a)
    first = cdf.searchsorted(rng.random(b), side="right")
    u = rng.random((s, 2, b))
    rule = u[:, 0] < dc.p_rule                                   # [S, B]
    zipf = cdf.searchsorted(u[:, 1], side="right")               # [S, B]
    seq = np.empty((b, s + 1), np.int64)
    seq[:, 0] = first
    for t in range(1, s + 1):
        seq[:, t] = np.where(rule[t - 1], _successor(seq[:, t - 1], v),
                             zipf[t - 1])
    out = _batch(seq)
    if dc.frame_len:
        frng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, dc.host_id, step, 1]))
        out["frames"] = frng.standard_normal(
            (b, dc.frame_len, dc.d_model), dtype=np.float32)
    return out


def stream(dc: DataConfig,
           start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield sample_batch(dc, step)
        step += 1


def data_config_for(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                    seed: int = 0, num_hosts: int = 1,
                    host_id: int = 0) -> DataConfig:
    frames = (dict(frame_len=cfg.encoder_seq_len, d_model=cfg.d_model)
              if cfg.is_encoder_decoder else {})
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      num_hosts=num_hosts, host_id=host_id, **frames)
