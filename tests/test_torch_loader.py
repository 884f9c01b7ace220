"""The port's eval loader against the JAX package's, batch for batch.

``rtdsd_tpu_torch.data.loader.EvalLoader`` must give exactly what
``rtdsd_tpu.data.loader.DataLoader(..., shuffle=False, pad_last=True)``
gives: the same waves, ids, labels and ``valid`` count in every batch, with
native decode on on both sides (one seed a batch, linear resampling in C++)
and with it off on both sides (one draw a row, polyphase resampling). The
cases: LA19-eval random-start crops, first-N crops, clips shorter than the
duration (tiled), 22.05 kHz clips, a FLAC file, and an undecodable file
under ``raise`` and ``skip``. The port's decoder is also held against the
JAX package's on FLAC and WAV files. Batch 4, 0.5 s windows.
"""

import warnings

import numpy as np
import pytest
import torch

from test_native import write_flac
from rtdsd_tpu.config import ExpConfig as JaxExp, SysConfig as JaxSys
from rtdsd_tpu.data.dataset import ASVspoof2019LA_eval as JaxLA19
from rtdsd_tpu.data.loader import DataLoader
from rtdsd_tpu.native import flac as jax_flac
from rtdsd_tpu_torch.config import ExpConfig, SysConfig
from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA_eval
from rtdsd_tpu_torch.data.io import write_wav
from rtdsd_tpu_torch.data.loader import EvalLoader
from rtdsd_tpu_torch.native import flac

BATCH = 4
DURATION_SEC = 0.5               # 8000 samples at 16 kHz
# (sample rate, length): longer than the window, so a random start moves it,
# and shorter, so the clip is tiled
CLIPS = {
    "random_start": [(16000, n) for n in (20000, 12000, 30000, 9000, 15000)],
    "short_tiled": [(16000, n) for n in (5000, 3000, 7999, 1234, 2500)],
    "22k": [(22050, n) for n in (15000, 9000, 4000, 30000, 11111)],
    "flac": [(16000, 12000), ("flac", 9000), (16000, 5000), ("flac", 4000),
             ("flac", 20000)],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_clip(path, sr, n, rng):
    t = np.arange(n)
    if sr == "flac":                 # 16 kHz, LPC(2) subframe, exact ints
        write_flac(path, [(1500 * np.sin(t / 9.0)).astype(np.int64)
                          + rng.integers(-20, 20, n)], kinds=("lpc2",))
    else:
        write_wav(path, (0.3 * np.sin(2 * np.pi * 330 * t / sr)
                         + 0.05 * rng.standard_normal(n)).astype(np.float32), sr)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{case: protocol path} over one audio folder, plus ``bad``: the
    random-start clips with one undecodable file in the first batch."""
    assert jax_flac.build_if_needed()
    root = tmp_path_factory.mktemp("torch_loader")
    audio = root / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    protos = {}
    for case, clips in CLIPS.items():
        lines = []
        for i, (sr, n) in enumerate(clips):
            uid = f"LA_E_{case}_{i}"
            _write_clip(str(audio / f"{uid}.flac"), sr, n, rng)
            label = "bonafide" if i % 2 else "spoof"
            lines.append(f"LA_0001 {uid} - A01 {label}")
        protos[case] = lines
    (audio / "LA_E_bad.flac").write_bytes(b"RIFF\x00\x00\x00\x00NOTAUDIO" * 4)
    protos["bad"] = (protos["random_start"][:2] + ["LA_0001 LA_E_bad - A01 spoof"]
                     + protos["random_start"][2:])
    out = {}
    for case, lines in protos.items():
        path = root / f"{case}.txt"
        path.write_text("\n".join(lines) + "\n")
        out[case] = str(path)
    return root, out


def _loaders(corpus, case, random_start, native, on_decode_error="raise"):
    """(port loader, JAX loader) over the LA19-eval dataset of ``case``."""
    root, protos = corpus
    paths = dict(path_label_asv_spoof_2019_la_eval=protos[case],
                 path_asv_spoof_2019_la_eval=str(root / "audio"))
    exp = dict(test_duration_sec=DURATION_SEC,
               la19_eval_random_start=None if random_start else False)
    mine = ASVspoof2019LA_eval(SysConfig(**paths), ExpConfig(**exp))
    ref = JaxLA19(JaxSys(**paths), JaxExp(**exp))
    assert mine.is_random_start == ref.is_random_start == random_start
    port = EvalLoader(mine, BATCH, num_workers=4, use_native=native,
                      on_decode_error=on_decode_error)
    jax_loader = DataLoader(ref, BATCH, shuffle=False, pad_last=True,
                            num_workers=4, use_native=native,
                            on_decode_error=on_decode_error)
    assert (port._native is None) == (jax_loader._native is None) == (not native)
    return port, jax_loader


def _assert_same_batches(port, jax_loader):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = list(port), list(jax_loader)
    assert len(got) == len(want) == len(port)
    for a, b in zip(got, want):
        assert a.utt_ids == b.utt_ids
        assert a.valid == b.valid
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.waves.shape == b.waves.shape == (BATCH, int(16000 * DURATION_SEC))
        np.testing.assert_array_equal(a.waves, b.waves)
    return got


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case,random_start", [
    ("random_start", True), ("random_start", False), ("short_tiled", True),
    ("22k", False), ("22k", True), ("flac", True)])
def test_eval_loader_matches_jax(corpus, case, random_start, native):
    batches = _assert_same_batches(*_loaders(corpus, case, random_start, native))
    n = len(CLIPS[case])
    assert [b.valid for b in batches] == [BATCH, n - BATCH]
    last = batches[-1]               # padding repeats the last real row
    assert last.utt_ids[last.valid:] == [last.utt_ids[last.valid - 1]] * (
        BATCH - last.valid)
    np.testing.assert_array_equal(last.waves[last.valid:],
                                  np.repeat(last.waves[last.valid - 1:last.valid],
                                            BATCH - last.valid, axis=0))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_eval_loader_undecodable_file(corpus, native):
    port, jax_loader = _loaders(corpus, "bad", True, native)
    for loader in (port, jax_loader):
        with pytest.raises((RuntimeError, ValueError)):
            list(loader)
    batches = _assert_same_batches(*_loaders(corpus, "bad", True, native,
                                             on_decode_error="skip"))
    # the bad row is left out of the first batch's valid rows, not scored
    assert [b.valid for b in batches] == [BATCH - 1, 2]
    assert "LA_E_bad" not in [u for b in batches for u in b.utt_ids]


def test_native_decode_matches_jax(corpus):
    root, _ = corpus
    files = sorted((root / "audio").glob("LA_E_[fr2]*.flac"))
    kinds = {f.read_bytes()[:4] for f in files}
    assert kinds == {b"fLaC", b"RIFF"}
    for f in files:
        got, sr = flac.decode(str(f))
        want, want_sr = jax_flac.decode(str(f))
        assert sr == want_sr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="native decode failed"):
        flac.decode(str(root / "audio" / "LA_E_bad.flac"))


def test_native_library_is_built_under_build_dir():
    from rtdsd_tpu_torch.ops import build

    path = flac.library_path()
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    flac.load()
    assert flac.build() == path
