"""Batches of decoded, duration-fit clips: the port of
``rtdsd_tpu/data/loader.py``'s ``DataLoader`` (one process, ``pad_last``).

:class:`DataLoader` is the training loader: with ``shuffle`` the order of
epoch ``e`` is ``numpy.random.default_rng(seed + e)``'s permutation
(:meth:`DataLoader.set_epoch`), and ``drop_last`` drops the last partial
batch. :class:`EvalLoader` gives batches in dataset order. A last partial
batch is padded to the batch size by repeating its last row, and ``valid``
says how many rows are real, so every batch has one shape and score writers
drop the padding. Both of the JAX loader's decode paths are here, with its
crop generator ``numpy.random.default_rng((seed, epoch, 0))`` (process 0):

- native (``use_native=True``, the default, as in the JAX CLI): one C call
  a batch decodes, resamples linearly, tiles and crops on ``num_workers``
  threads (:mod:`rtdsd_tpu_torch.native.flac`); a random-start dataset
  draws one seed a batch and the library derives each row's start from it;
- Python (``use_native=False``): ``AudioDataset.get`` row by row, one draw
  a row for a random start, polyphase resampling.

A dataset's ``host_augment`` draws from the same generator after the crop:
row by row inside ``get`` on the Python path, over the padded batch on the
native one, as the JAX loader does.

Decode runs on the calling thread: the scoring loop leaves the GPU working
asynchronously meanwhile.
"""

from __future__ import annotations

import warnings
from typing import Iterator, List, NamedTuple

import numpy as np

from rtdsd_tpu_torch.data.dataset import AudioDataset


class Batch(NamedTuple):
    utt_ids: List[str]
    waves: np.ndarray          # (B, duration) float32
    labels: np.ndarray         # (B,) int32
    valid: int


class DataLoader:
    def __init__(self, dataset: AudioDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 1024, num_workers: int = 2,
                 use_native: bool = True, on_decode_error: str = "raise"):
        if on_decode_error not in ("raise", "skip"):
            raise ValueError(f"on_decode_error must be 'raise' or 'skip', "
                             f"got {on_decode_error!r}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle, self.drop_last = shuffle, drop_last
        self.epoch = 0
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.on_decode_error = on_decode_error
        self._native = None
        if use_native:               # builds the library now, or raises
            from rtdsd_tpu_torch.native import flac

            flac.load()
            self._native = flac

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _make_batch(self, indices, rng) -> Batch:
        if self._native is not None:
            return self._make_batch_native(indices, rng)
        ids, waves, labels = [], [], []
        for i in indices:
            try:
                uid, wave, label = self.dataset.get(int(i), rng)
            except (OSError, ValueError, RuntimeError) as e:
                if self.on_decode_error == "raise":
                    raise
                warnings.warn(f"skipping undecodable item "
                              f"{self.dataset.trials[int(i)].path}: {e}")
                continue
            ids.append(uid)
            waves.append(wave)
            labels.append(label)
        if not ids:
            raise RuntimeError("every item in the batch failed to decode")
        valid = len(ids)
        for _ in range(self.batch_size - valid):
            ids.append(ids[-1])
            waves.append(waves[-1])
            labels.append(labels[-1])
        return Batch(ids, np.stack(waves), np.asarray(labels, np.int32), valid)

    def _make_batch_native(self, indices, rng) -> Batch:
        trials = [self.dataset.trials[int(i)] for i in indices]
        seed = (int(rng.integers(1, 2 ** 62))
                if self.dataset.is_random_start else 0)
        waves, failed_idx = self._native.load_batch_status(
            [t.path for t in trials], self.dataset.duration, seed=seed,
            threads=self.num_workers, expected_sr=self.dataset.sample_rate)
        if len(failed_idx):
            bad = [trials[int(i)].path for i in failed_idx]
            more = "..." if len(bad) > 4 else ""
            if self.on_decode_error == "raise":
                raise RuntimeError(
                    f"native decode failed for {len(bad)} file(s) in batch: "
                    f"{bad[:4]}{more}")
            if len(failed_idx) == len(trials):
                raise RuntimeError("every item in the batch failed to decode")
            warnings.warn(f"skipping {len(bad)} undecodable item(s): "
                          f"{bad[:4]}{more}")
            # failed rows are zero: drop them, so they are never scored
            # under a wrong id; the padding below restores the shape
            bad_set = set(int(i) for i in failed_idx)
            keep = [i for i in range(len(trials)) if i not in bad_set]
            waves = waves[keep]
            trials = [trials[i] for i in keep]
        valid = len(trials)
        if valid < self.batch_size:
            reps = self.batch_size - valid
            waves = np.concatenate([waves, np.repeat(waves[-1:], reps, axis=0)])
            trials = trials + [trials[-1]] * reps
        aug = self.dataset.host_augment
        if aug is not None:
            waves = np.stack([aug(w, rng) for w in waves])
        return Batch([t.utt_id for t in trials], waves,
                     np.asarray([t.label for t in trials], np.int32), valid)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, self.epoch, 0))
        idx = self._indices()
        for b in range(len(self)):
            yield self._make_batch(idx[b * self.batch_size:
                                       (b + 1) * self.batch_size], rng)


class EvalLoader(DataLoader):
    """Batches in dataset order, the last one padded."""

    def __init__(self, dataset: AudioDataset, batch_size: int,
                 seed: int = 1024, num_workers: int = 2,
                 use_native: bool = True, on_decode_error: str = "raise"):
        super().__init__(dataset, batch_size, seed=seed,
                         num_workers=num_workers, use_native=use_native,
                         on_decode_error=on_decode_error)
