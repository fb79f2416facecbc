"""Deterministic, shard-aware synthetic token pipeline (the port's copy of
``repro.data.pipeline``: numpy only, so batch ``step`` is the same array for
the same ``(seed, step, host)`` in both packages).

Design goals (what a production input pipeline must guarantee):

  * **determinism**: batch ``i`` is a pure function of (seed, i) — restarts
    resume mid-epoch without data loss or duplication (the pipeline state is
    just the step counter, which the checkpoint already stores);
  * **shard-awareness**: each data-parallel host materializes only its slice
    of the global batch (``host_slice``), so input bytes scale with the
    host count rather than the global batch;
  * **structured synthetic text**: tokens follow a deterministic mixture of
    Zipfian unigrams and a repeated-ngram process, giving the LM a learnable
    signal (loss decreases measurably within a few hundred steps) unlike
    uniform noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_prob: float = 0.35
    ngram: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # fixed Zipfian unigram distribution over the vocab
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks**self.zipf_a
        self._p = p / p.sum()
        # a bank of "phrases" the stream repeats (learnable structure)
        self._phrases = rng.integers(
            0, self.vocab_size, size=(256, self.ngram), dtype=np.int64
        )

    # ------------------------------------------------------------------
    def batch(self, step: int) -> dict:
        """The full global batch for ``step`` (deterministic in (seed, step))."""
        return self.host_slice(step, 0, 1)

    def host_slice(self, step: int, host_idx: int, n_hosts: int) -> dict:
        """This host's slice of global batch ``step``."""
        assert self.global_batch % n_hosts == 0
        per = self.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_idx])
        )
        b, s = per, self.seq_len
        toks = rng.choice(self.vocab_size, size=(b, s + 1), p=self._p).astype(np.int64)
        # overwrite random spans with repeated phrases
        n_spans = int(self.repeat_prob * (s + 1) / self.ngram)
        for i in range(b):
            starts = rng.integers(0, s + 1 - self.ngram, size=n_spans)
            ids = rng.integers(0, len(self._phrases), size=n_spans)
            for st, pid in zip(starts, ids):
                toks[i, st : st + self.ngram] = self._phrases[pid]
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


def make_batch(cfg, batch: int, seq: int, *, step: int = 0, seed: int = 0) -> dict:
    """Convenience: one batch shaped for ``cfg`` (adds stub frames for
    vlm/encdec frontends)."""
    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq, batch, seed=seed)
    out = {k: v for k, v in pipe.batch(step).items()}
    if cfg.family in ("vlm", "encdec"):
        nf = cfg.n_frontend_tokens or 64
        rng = np.random.default_rng(seed + 1)
        out["frames"] = rng.standard_normal((batch, nf, cfg.d_model)).astype(np.float32) * 0.02
    return out
