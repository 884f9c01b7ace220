"""Sequential eval batches: the port of the eval side of
``rtdsd_tpu/data/loader.py``.

Batches come in dataset order. The last partial batch is padded to the batch
size by repeating its last row, and ``valid`` says how many rows are real, so
every batch has one shape and score writers drop the padding. Random crops
(LA19 eval) draw from ``numpy.random.default_rng((seed, 0, 0))``, the seed
of the JAX loader's Python decode path (epoch 0, process 0). Decode runs on
the calling thread: the scoring loop leaves the GPU working asynchronously
meanwhile.
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
                 seed: int = 1024, on_decode_error: str = "raise"):
        if on_decode_error not in ("raise", "skip"):
            raise ValueError(f"on_decode_error must be 'raise' or 'skip', "
                             f"got {on_decode_error!r}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.on_decode_error = on_decode_error

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _make_batch(self, indices, rng) -> Batch:
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

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, 0, 0))
        n = len(self.dataset)
        for s in range(0, n, self.batch_size):
            yield self._make_batch(range(s, min(s + self.batch_size, n)), rng)
