"""Sequential eval batches: the port of the eval side of
``rtdsd_tpu/data/loader.py`` (``DataLoader(shuffle=False, pad_last=True)``).

Batches come in dataset order. The last partial batch is padded to the batch
size by repeating its last row, and ``valid`` says how many rows are real, so
every batch has one shape and score writers drop the padding. Both of the
JAX loader's decode paths are here, with its generator
``numpy.random.default_rng((seed, 0, 0))`` (epoch 0, process 0):

- native (``use_native=True``, the default, as in the JAX CLI): one C call
  a batch decodes, resamples linearly, tiles and crops on ``num_workers``
  threads (:mod:`rtdsd_tpu_torch.native.flac`); a random-start dataset
  draws one seed a batch and the library derives each row's start from it;
- Python (``use_native=False``): ``AudioDataset.get`` row by row, one draw
  a row for a random start, polyphase resampling.

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


class EvalLoader:
    def __init__(self, dataset: AudioDataset, batch_size: int,
                 seed: int = 1024, num_workers: int = 2,
                 use_native: bool = True, on_decode_error: str = "raise"):
        if on_decode_error not in ("raise", "skip"):
            raise ValueError(f"on_decode_error must be 'raise' or 'skip', "
                             f"got {on_decode_error!r}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.on_decode_error = on_decode_error
        self._native = None
        if use_native:               # builds the library now, or raises
            from rtdsd_tpu_torch.native import flac

            flac.load()
            self._native = flac

    def __len__(self) -> int:
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
        return Batch([t.utt_id for t in trials], waves,
                     np.asarray([t.label for t in trials], np.int32), valid)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, 0, 0))
        n = len(self.dataset)
        for s in range(0, n, self.batch_size):
            yield self._make_batch(range(s, min(s + self.batch_size, n)), rng)
