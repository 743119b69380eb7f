"""Speaker-grouped batch sampler for GE2E training (counterpart of
puresound_tpu/src/sampler.py:12-36, copied: the port imports nothing of the
JAX package). Each batch is n_spks speakers x n_per utterance indices,
grouped by speaker, drawn from Python's global `random` as JAX's sampler
draws them."""
from __future__ import annotations

import random
from typing import Dict, List


class SpeakerSampler:
    """meta: {speaker: [utterance indices]}; n_batch batches, each n_spks
    speakers x n_per utterances (with replacement where a speaker has too
    few)."""

    def __init__(self, meta: Dict[str, List[int]], n_batch: int,
                 n_spks: int, n_per: int):
        self.meta = meta
        self.n_batch = n_batch
        self.n_spks = n_spks
        self.n_per = n_per

    def __len__(self):
        return self.n_batch

    def __iter__(self):
        for _ in range(self.n_batch):
            batch = []
            classes = random.sample(sorted(self.meta.keys()), self.n_spks)
            for c in classes:
                utts = self.meta[c]
                if len(utts) >= self.n_per:
                    batch.extend(random.sample(utts, self.n_per))
                else:
                    batch.extend(random.choices(utts, k=self.n_per))
            yield batch
