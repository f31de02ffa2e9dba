"""Feature dataset and static-shape bucketed batching (counterpart of
`bisinger_tpu/data/dataset.py:58-371`).

  - items are read from the binarizer's `RecordReader` shards;
  - ordering: a random permutation, then a stable sort by length
    (`ordered_indices`), so batches are length-homogeneous;
  - batches are filled under a token budget (`batch_by_size`:
    `max_tokens` / `max_sentences`), then padded to static bucket shapes,
    the smallest (`bucket_tokens`, `bucket_frames`) pair that fits;
  - each epoch's order comes from `RandomState(seed + epoch)`, so the
    port's batches are the JAX package's at the same seed.

Everything is numpy on the host. Beside the binarized fields (the speaker
vector `spk_embed` among them, where the binarizer wrote one) an item
carries the frame energy (`use_energy_embed`; `energy_convention` "ref",
the reference's e**mel, else 10**mel), the offline task's recorded fs2 mel
(`fs2_mel_dir/<item_name>.npy`) and, with `pitch_type: cwt`, the binarized
CWT spectrogram (`cwt_spec`) with the log-f0's mean and std (`f0_mean`,
`f0_std`).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from bisinger_tpu_torch.data.records import RecordReader
from bisinger_tpu_torch.utils.pitch import norm_interp_f0_np

# host-only fields of a collated batch; the rest are arrays
NON_ARRAY_KEYS = ("item_names", "ids", "nsamples")


def pad_1d(xs: Sequence[np.ndarray], length: int, pad_value=0) -> np.ndarray:
    out = np.full((len(xs), length), pad_value, dtype=np.asarray(xs[0]).dtype)
    for i, x in enumerate(xs):
        out[i, : len(x)] = x[:length]
    return out


def pad_2d(xs: Sequence[np.ndarray], length: int, pad_value=0.0) -> np.ndarray:
    dim = xs[0].shape[1]
    out = np.full((len(xs), length, dim), pad_value, dtype=xs[0].dtype)
    for i, x in enumerate(xs):
        out[i, : x.shape[0]] = x[:length]
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class M4SingerDataset:
    """Per-item feature dict for the BiSinger stack (reference
    `M4SingerDataset`, `usr/diffsinger_task.py:336-377`)."""

    def __init__(self, hp, prefix: str, shuffle: bool = False):
        self.hp = hp
        self.prefix = prefix
        self.shuffle = shuffle
        self.reader = RecordReader(f"{hp['binary_data_dir']}/{prefix}")
        self.sizes = np.asarray(
            [int(r) for r in np.load(f"{hp['binary_data_dir']}/{prefix}_lengths.npy")])

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        hp = self.hp
        item = self.reader[index]
        mel = item["mel"][: hp["max_frames"]].astype(np.float32)
        t = mel.shape[0]
        sample = {
            "id": index,
            "item_name": item.get("item_name", str(index)),
            "txt_tokens": np.asarray(item["phone"], dtype=np.int64),
            "mel": mel,
            "mel2ph": np.asarray(item["mel2ph"], dtype=np.int64)[:t],
            "spk_id": int(item.get("spk_id", 0)),
        }
        if hp.get("use_energy_embed"):
            # the frame energy of the log-mel (`dataset.py:85-97`): e**mel by
            # default, as the reference's energy ids were trained on; any other
            # convention the dimensionally consistent 10**mel
            lin = np.exp(mel) if hp.get("energy_convention", "ref") == "ref" else 10.0 ** mel
            sample["energy"] = np.sqrt((lin ** 2).sum(-1)).astype(np.float32)
        if hp["binarization_args"].get("with_f0", True) and "f0" in item:
            if hp["pitch_norm"] == "standard" and not hp.get("f0_mean"):
                raise ValueError("pitch_norm: standard requires f0_mean/f0_std in the config")
            f0, uv = norm_interp_f0_np(
                item["f0"][:t], hp["pitch_norm"], f0_mean=hp.get("f0_mean") or 0.0,
                f0_std=hp.get("f0_std") or 1.0, use_uv=hp["use_uv"])
            sample["f0"] = f0
            sample["uv"] = uv
        for key in ("pitch_midi", "midi_dur", "is_slur", "word_boundary", "lang", "ph_is_sil"):
            if key in item:
                sample[key] = np.asarray(item[key])
        if hp.get("pitch_type") == "cwt" and "cwt_spec" in item:
            sample["cwt_spec"] = item["cwt_spec"][:t].astype(np.float32)
            sample["f0_mean"] = float(item["cwt_mean"])
            sample["f0_std"] = float(item["cwt_std"])
        if "speechsing" in item:
            sample["speechsing"] = int(np.asarray(item["speechsing"]).reshape(-1)[0])
        if "spk_embed" in item:
            sample["spk_embed"] = np.asarray(item["spk_embed"], np.float32)
        if hp.get("fs2_mel_dir"):
            # offline shallow diffusion: the fs2 stage's mel of this item, cut
            # or zero-padded to its frames (`dataset.py:117-130`)
            fs2_mel = np.load(os.path.join(hp["fs2_mel_dir"], f"{sample['item_name']}.npy"))
            fs2_mel = fs2_mel[:t].astype(np.float32)
            if fs2_mel.shape[0] < t:
                fs2_mel = np.pad(fs2_mel, ((0, t - fs2_mel.shape[0]), (0, 0)))
            sample["fs2_mel"] = fs2_mel
        return sample

    def ordered_indices(self, rng: np.random.RandomState) -> np.ndarray:
        """A permutation stably sorted by length when shuffling (reference
        `base_task.py:62-72`), else the shard order."""
        if not self.shuffle:
            return np.arange(len(self))
        idx = rng.permutation(len(self))
        if self.hp.get("sort_by_len", True):
            idx = idx[np.argsort(self.sizes[idx], kind="mergesort")]
        return idx


def batch_by_size(indices: np.ndarray, sizes: np.ndarray, max_tokens: int, max_sentences: int,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    """Greedy token-budget batching (reference `utils/__init__.py:90-143`):
    a batch closes when the next item would exceed max_tokens (batch size
    times the longest item) or max_sentences; batch sizes are rounded down
    to the multiple."""
    batches: List[List[int]] = []
    batch: List[int] = []
    sample_len = 0
    for idx in indices:
        idx = int(idx)
        sz = int(sizes[idx])
        sample_len = max(sample_len, sz)
        num_tokens = (len(batch) + 1) * sample_len
        if batch and (num_tokens > max_tokens
                      or (max_sentences > 0 and len(batch) == max_sentences)):
            mod = len(batch) % required_batch_size_multiple
            if mod != 0 and len(batch) > mod:
                batches.append(batch[: len(batch) - mod])
                batch = batch[len(batch) - mod:]
            else:
                batches.append(batch)
                batch = []
            sample_len = sz if not batch else max(sizes[batch].max(), sz)
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


_TRUNC_WARNED = False


def collate_batch(samples: List[Dict[str, Any]], hp, static_shapes: bool = True
                  ) -> Dict[str, Any]:
    """Pad samples into one batch dict; with static_shapes the lengths snap
    to the configured buckets. Frames aligned to phones past the largest
    token bucket become padding (mel2ph 0)."""
    global _TRUNC_WARNED
    t_txt = max(len(s["txt_tokens"]) for s in samples)
    t_mel = max(s["mel"].shape[0] for s in samples)
    if static_shapes:
        t_txt = pick_bucket(t_txt, hp["bucket_tokens"])
        t_mel = pick_bucket(t_mel, hp["bucket_frames"])
    mel2ph = pad_1d([s["mel2ph"] for s in samples], t_mel)
    if int(mel2ph.max(initial=0)) > t_txt:
        if not _TRUNC_WARNED:
            _TRUNC_WARNED = True
            print(f"| WARNING: items longer than the largest token bucket ({t_txt}) are "
                  "being truncated — raise bucket_tokens or lower max_input_tokens to avoid "
                  "losing phones", flush=True)
        mel2ph = np.where(mel2ph <= t_txt, mel2ph, 0)
    batch: Dict[str, Any] = {
        "ids": np.asarray([s["id"] for s in samples]),
        "item_names": [s["item_name"] for s in samples],
        "nsamples": len(samples),
        "txt_tokens": pad_1d([s["txt_tokens"] for s in samples], t_txt),
        "mels": pad_2d([s["mel"] for s in samples], t_mel),
        "mel2ph": mel2ph,
        "spk_ids": np.asarray([s["spk_id"] for s in samples], dtype=np.int64),
    }
    if "fs2_mel" in samples[0]:
        batch["fs2_mels"] = pad_2d([s["fs2_mel"] for s in samples], t_mel)
    if "energy" in samples[0]:
        batch["energy"] = pad_1d([s["energy"] for s in samples], t_mel).astype(np.float32)
    if "spk_embed" in samples[0]:
        batch["spk_embed"] = np.stack([s["spk_embed"] for s in samples])
    if "f0" in samples[0]:
        batch["f0"] = pad_1d([s["f0"] for s in samples], t_mel).astype(np.float32)
        batch["uv"] = pad_1d([s["uv"] for s in samples], t_mel).astype(np.float32)
    for key in ("pitch_midi", "is_slur", "word_boundary", "lang", "ph_is_sil"):
        if key in samples[0]:
            batch[key] = pad_1d([s[key] for s in samples], t_txt)
    if "midi_dur" in samples[0]:
        batch["midi_dur"] = pad_1d([s["midi_dur"] for s in samples], t_txt).astype(np.float32)
    if "cwt_spec" in samples[0]:
        batch["cwt_spec"] = pad_2d([s["cwt_spec"] for s in samples], t_mel)
        batch["f0_mean"] = np.asarray([s["f0_mean"] for s in samples], np.float32)
        batch["f0_std"] = np.asarray([s["f0_std"] for s in samples], np.float32)
    if "speechsing" in samples[0]:
        batch["speechsing"] = np.asarray([s["speechsing"] for s in samples], dtype=np.int64)
    return batch


_INT_KEYS = ("txt_tokens", "mel2ph", "spk_ids", "pitch_midi", "is_slur", "word_boundary",
             "lang", "ph_is_sil", "speechsing")


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch -> tensors on `device` (integers as int64,
    the rest fp32), without the host-only fields."""
    out = {}
    for k, v in batch.items():
        if k in NON_ARRAY_KEYS:
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, torch.long if k in _INT_KEYS else torch.float32)
    return out


def _slice_batch_rows(batch: Dict[str, Any], shard_index: int, num_shards: int
                      ) -> Dict[str, Any]:
    """This rank's row range of a collated batch (an equal split; the loader
    pads the sample list to a multiple of num_shards first), as
    `bisinger_tpu/data/dataset.py:259-277`."""
    n = int(batch["txt_tokens"].shape[0])
    per = n // num_shards
    lo, hi = shard_index * per, (shard_index + 1) * per
    out = {}
    for k, v in batch.items():
        if k == "nsamples":
            out[k] = per
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = v[lo:hi]
        elif isinstance(v, list) and len(v) == n:
            out[k] = v[lo:hi]
        else:
            out[k] = v
    return out


class DataLoader:
    """Epoch iterator: order -> budget batches -> collate -> rows of this
    rank. `endless` repeats with a fresh order each epoch. The padded batch
    repeats its last sample up to a multiple of lcm(`batch_multiple`,
    `num_shards`) (`pad_batch_to_multiple`), as the JAX package pads for its
    device count: the ESM attends across the batch, so the padding rows
    reach the real ones and must be the same. With `num_shards` > 1 every
    rank collates the whole global batch (the same seed, so the same
    buckets) and keeps its equal share of the rows (`shard_index`), as
    `bisinger_tpu/data/dataset.py:340-365`."""

    def __init__(self, dataset: M4SingerDataset, hp, shuffle: bool = True,
                 max_tokens: Optional[int] = None, max_sentences: Optional[int] = None,
                 batch_multiple: int = 1, shard_index: int = 0, num_shards: int = 1,
                 endless: bool = False, seed: int = 1234, pad_batch_to_multiple: bool = True):
        self.dataset = dataset
        self.hp = hp
        self.shuffle = shuffle
        self.max_tokens = max_tokens if max_tokens is not None else hp["max_tokens"]
        self.max_sentences = max_sentences if max_sentences is not None else hp["max_sentences"]
        self.batch_multiple = batch_multiple
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.endless = endless
        self.seed = seed
        self.epoch = 0
        self.pad_batch_to_multiple = pad_batch_to_multiple

    def _epoch_batches(self, epoch: int) -> List[List[int]]:
        rng = np.random.RandomState(self.seed + epoch if self.shuffle else self.seed)
        indices = self.dataset.ordered_indices(rng)
        batches = batch_by_size(indices, self.dataset.sizes, self.max_tokens,
                                self.max_sentences, self.batch_multiple)
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def batches_per_epoch(self) -> int:
        return len(self._epoch_batches(0))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            for batch_idx in self._epoch_batches(self.epoch):
                samples = [self.dataset[i] for i in batch_idx]
                # a multiple of both, or the row split would drop rows
                mult = math.lcm(self.batch_multiple, self.num_shards)
                if self.pad_batch_to_multiple and mult > 1:
                    while len(samples) % mult:
                        samples.append(samples[-1])
                batch = collate_batch(samples, self.hp)
                if self.num_shards > 1:
                    batch = _slice_batch_rows(batch, self.shard_index, self.num_shards)
                yield batch
            self.epoch += 1
            if not self.endless:
                return

