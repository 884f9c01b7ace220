"""ASVspoof / In-the-Wild protocol parsers: the port's own copy of
``rtdsd_tpu/data/protocols.py`` (same field layouts, same trial ids).

- 2019 LA train, dev and eval: ``file = fields[1]``, ``attack =
  fields[3]``, bonafide iff ``fields[4] == 'bonafide'``; optional exclusion
  of ``no_speech`` / ``residual`` utterances (train and dev also count
  spoof and bonafide lines before the exclusions).
- 2021 LA eval: ``file = fields[1]``, label from ``fields[4]``.
- 2021 DF eval: ``file = fields[1]``, label from ``fields[5]``; with the
  ``*_spec`` flag, ``file = fields[0]`` and label 1.
- In-the-Wild: ``file = fields[0]``, label from ``fields[1]``; ``.wav``
  appended when absent.
- ASVspoof5: ``file = fields[0]``, subset ``fields[1]``, label from
  ``fields[2]``; the trial id is the full path.
- FakeOrReal: the In-the-Wild 2-field layout.

Each parser returns a list of :class:`Trial` (path, utt_id, label, attack).
Labels: 1 = bonafide, 0 = spoof.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Trial:
    path: str
    utt_id: str
    label: int
    attack: str = ""


def _read_lines(path: str) -> List[List[str]]:
    with open(path) as f:
        return [ln.strip().split() for ln in f if ln.strip()]


def parse_asvspoof2019_train(label_path: str, audio_dir: str,
                             include_non_speech: bool = True,
                             include_residual: bool = True
                             ) -> Tuple[List[Trial], int, int]:
    """-> (trials, spoof lines, bonafide lines); the counts include the
    lines the exclusions drop, as the reference counts."""
    n_spoof = n_bona = 0
    for f in _read_lines(label_path):
        if f[4] == "bonafide":
            n_bona += 1
        else:
            n_spoof += 1
    return (parse_asvspoof2019_eval(label_path, audio_dir, include_non_speech,
                                    include_residual), n_spoof, n_bona)


def parse_asvspoof2019_eval(label_path: str, audio_dir: str,
                            include_non_speech: bool = True,
                            include_residual: bool = True) -> List[Trial]:
    trials = []
    for f in _read_lines(label_path):
        file, attack = f[1], f[3]
        label = 1 if f[4] == "bonafide" else 0
        if "no_speech" in file and not include_non_speech:
            continue
        if "residual" in file and not include_residual:
            continue
        trials.append(Trial(os.path.join(audio_dir, f"{file}.flac"),
                            file, label, attack))
    return trials


def parse_asvspoof2021_la(label_path: str, audio_dir: str) -> List[Trial]:
    return [Trial(os.path.join(audio_dir, f"{f[1]}.flac"), f[1],
                  1 if f[4] == "bonafide" else 0, f[4])
            for f in _read_lines(label_path)]


def parse_asvspoof2021_df(label_path: str, audio_dir: str,
                          spec: bool = False) -> List[Trial]:
    trials = []
    for f in _read_lines(label_path):
        if spec:
            file, attack, label = f[0], "", 1
        else:
            file, attack = f[1], f[5]
            label = 1 if f[5] == "bonafide" else 0
        trials.append(Trial(os.path.join(audio_dir, f"{file}.flac"),
                            file, label, attack))
    return trials


def parse_in_the_wild(label_path: str, audio_dir: str) -> List[Trial]:
    trials = []
    for f in _read_lines(label_path):
        file = f[0]
        label = 1 if f[1] == "bonafide" else 0
        rel = file if file.endswith(".wav") else f"{file}.wav"
        utt_id = os.path.splitext(os.path.basename(file))[0]
        trials.append(Trial(os.path.join(audio_dir, rel), utt_id, label))
    return trials


def parse_asvspoof5(label_path: str, audio_dir: str,
                    subset: Optional[str] = None) -> List[Trial]:
    trials = []
    for f in _read_lines(label_path):
        file, sub = f[0], f[1]
        label = 1 if f[2] == "bonafide" else 0
        if subset is not None and sub != subset:
            continue
        path = os.path.join(audio_dir, file)
        # the trial id is the full path, as in the reference's score files
        trials.append(Trial(path, path, label, sub))
    return trials


def parse_fake_or_real(label_path: str, audio_dir: str) -> List[Trial]:
    trials = []
    for f in _read_lines(label_path):
        file = f[0]
        label = 1 if f[1] in ("bonafide", "real") else 0
        rel = file if os.path.splitext(file)[1] else f"{file}.wav"
        trials.append(Trial(os.path.join(audio_dir, rel),
                            os.path.splitext(os.path.basename(file))[0],
                            label))
    return trials
