"""Deterministic, resumable data pipeline: a copy of the JAX package's
``data/pipeline.py`` (numpy only, so the port keeps its own copy rather than
import it).

State is a single integer cursor (+ the immutable seed): batch k is a pure
function of (seed, k), so carrying the cursor in the DFC announcement makes
data position part of the detectable checkpoint -- on recovery the pipeline
resumes from exactly the committed batch, a prerequisite for exactly-once
training semantics.

Synthetic token stream (language-model-shaped: zipfian tokens, shifted-label
construction).  ``batch_at`` returns numpy arrays; the training runtime
moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DataPipeline:
    vocab: int
    batch_size: int
    seq_len: int
    seed: int = 0
    worker: int = 0
    n_workers: int = 1
    zipf_a: float = 1.2

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, worker, cursor)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + cursor) * 65_537 + self.worker
        )
        raw = rng.zipf(self.zipf_a, size=(self.batch_size, self.seq_len + 1))
        toks = (raw - 1) % self.vocab
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def embeddings_batch_at(self, cursor: int, d_model: int) -> Dict[str, np.ndarray]:
        """For embedding-input archs (musicgen): precomputed frame embeddings."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + cursor) * 65_537 + self.worker + 7
        )
        emb = rng.standard_normal((self.batch_size, self.seq_len, d_model)) * 0.02
        labels = rng.integers(0, self.vocab, (self.batch_size, self.seq_len))
        return {
            "embeddings": emb.astype(np.float32),
            "labels": labels.astype(np.int32),
        }
