"""Device-resident corpus feeding (counterpart of
`bisinger_tpu/data/device_corpus.py`, `device_resident_corpus: true`, the
flagship's setting): no per-step host-to-device copy of a batch.

  1. every item is collated once to the static bucket shapes (the same
     `DataLoader` collate path as the streaming mode, at B=1);
  2. the items are stacked to [N, ...] and copied to the device once;
  3. each step gathers a batch of B rows on the device with
     `index_select`; only the B indices cross.

B is max_sentences capped by the frame budget (max_tokens over the widest
frame bucket), rounded up to a multiple of the ranks (as
`bisinger_tpu/data/device_corpus.py:83-87` rounds to the data axis). Every
rank holds the whole corpus and draws the same index vector of the global
batch (the same seed), then gathers only its rows: JAX's replicated corpus
with a batch-sharded gather, one process a rank. The order is a fresh
permutation from `RandomState(seed)` each epoch. The tail is dropped as in
the JAX package: when fewer than B positions of the permutation are left,
the next batch starts a new permutation, so each epoch yields floor(N / B)
batches of B rows and the last N mod B items of a permutation sit that
epoch out. Every batch keeps one static shape, and the batches equal the
JAX package's at the same seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bisinger_tpu_torch.data.dataset import DataLoader, batch_to_device


class DeviceResidentFeeder:
    """Endless iterator of batches gathered on `device`: the rows of rank
    `shard_index` of `num_shards` of each global batch."""

    def __init__(self, dataset, hp, device, seed: int = 1234, shard_index: int = 0,
                 num_shards: int = 1):
        dl = DataLoader(dataset, hp, shuffle=False, endless=False, max_tokens=10 ** 9,
                        max_sentences=1, pad_batch_to_multiple=False)
        rows: Dict[str, list] = {}
        for b in dl:
            for k, v in batch_to_device(b, "cpu").items():
                rows.setdefault(k, []).append(v)
        if not rows:
            raise ValueError("the dataset holds no item")
        stacked = {}
        for k, vs in rows.items():
            if vs[0].ndim > 1:  # several buckets: pad every item to the widest
                t_max = max(v.shape[1] for v in vs)
                vs = [torch.nn.functional.pad(v, [0, 0] * (v.ndim - 2) + [0, t_max - v.shape[1]])
                      for v in vs]
            stacked[k] = torch.cat(vs, dim=0)
        self.n_items = next(iter(stacked.values())).shape[0]
        t_bucket = int(stacked["mels"].shape[1])
        budget = max(int(hp["max_tokens"]) // max(t_bucket, 1), 1)
        ms = int(hp.get("max_sentences", 0) or 0)
        self.batch_size = min(ms, budget) if 0 < ms <= 100_000 else budget
        self.shard_index, self.num_shards = shard_index, num_shards
        self.batch_size = -(-self.batch_size // self.num_shards) * self.num_shards
        self.device = torch.device(device)
        self.corpus = {k: v.to(self.device) for k, v in stacked.items()}
        self.bytes_resident = sum(v.numel() * v.element_size() for v in self.corpus.values())
        self._rng = np.random.RandomState(seed)
        self._perm = np.empty(0, np.int64)
        self._pos = 0

    def next_indices(self) -> np.ndarray:
        b = self.batch_size
        if self._pos + b > len(self._perm):
            self._perm = self._rng.permutation(self.n_items)
            while len(self._perm) < b:  # a corpus shorter than a batch: tile
                self._perm = np.concatenate([self._perm, self._rng.permutation(self.n_items)])
            self._pos = 0
        out = self._perm[self._pos:self._pos + b]
        self._pos += b
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        per = self.batch_size // self.num_shards
        rows = self.next_indices()[self.shard_index * per:(self.shard_index + 1) * per]
        idx = torch.as_tensor(rows, dtype=torch.long).to(self.device)
        return {k: v.index_select(0, idx) for k, v in self.corpus.items()}
