"""The port's profiler spans (``rtdsd_tpu_torch/utils/spans.py``) on the
CPU: no ``record_function`` is entered while no profiler runs; under one,
a ``poll`` of a tiny serving engine and a ``score_dataset`` call over a few
tiny WAV files record the documented spans, nested as documented; the
answers do not depend on the profiler; and ``torch.export`` under a
profiler enters none of them."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtdsd_tpu_torch.cli.common import score_dataset
from rtdsd_tpu_torch.data.dataset import AudioDataset
from rtdsd_tpu_torch.data.io import write_wav
from rtdsd_tpu_torch.data.protocols import Trial
from rtdsd_tpu_torch.engine.serving import MultiStreamScorer
from rtdsd_tpu_torch.models import registry
from rtdsd_tpu_torch.models.zoo import init_weights
from rtdsd_tpu_torch.utils import spans

W2V = {"conv_layers": [[8, 10, 5], [8, 4, 4], [8, 2, 2]],
       "encoder_embed_dim": 8, "encoder_ffn_dim": 16, "encoder_heads": 2,
       "conv_pos": 4, "conv_pos_groups": 2}
LAYERS = 2
DUR = 80 * 40                 # 3200 samples, 80 frames of stride 40
HOP = DUR // 2
SR = 16000
PREFIXES = ("serve.", "score.", "model.")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    spec = registry.get_model("My_XLSR_AASIST", num_layers=LAYERS, w2v=W2V)
    init_weights(spec.module, 3)
    spec.module.eval()
    return spec


@pytest.fixture(scope="module")
def model(spec):
    return spec.module


def _poll_once(model):
    """One poll of a fresh two-stream engine that has a segment and a
    window due for each stream -> its scores."""
    eng = MultiStreamScorer(model, model.w2v_cfg, duration=DUR, hop=HOP,
                            max_streams=2)
    rng = np.random.default_rng(11)
    for s in range(2):
        h = eng.open_stream(s)
        eng.push(h, (rng.standard_normal(2 * DUR) * 0.1).astype(np.float32))
    return eng, [(r.stream_id, r.start_sample, r.score) for r in eng.poll()]


@pytest.fixture(scope="module")
def track(tmp_path_factory):
    """Five WAV files of 0.1-0.3 s, scored at batch 2 on 0.2 s crops."""
    root = tmp_path_factory.mktemp("spans_track")
    rng = np.random.default_rng(5)
    trials = []
    for i, n in enumerate((1600, 4000, 3200, 4800, 2400)):
        path = os.path.join(root, f"u{i}.wav")
        write_wav(path, (rng.standard_normal(n) * 0.2).astype(np.float32),
                  SR)
        trials.append(Trial(path=path, utt_id=f"u{i}", label=0))
    return AudioDataset(trials, DUR, is_random_start=False, sample_rate=SR)


def _score(spec, ds):
    return score_dataset(ds, spec, 2,
                         torch.device("cpu"), num_workers=1)


def _spans(prof):
    """The program's spans of a profile: [(name, start, end)] by start,
    the enclosing span before the spans it encloses."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(PREFIXES)]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner != outer


def _children(all_spans, parent):
    """The spans directly inside ``parent``, in time order."""
    within = [s for s in all_spans if _inside(s, parent)]
    return [s for s in within
            if not any(_inside(s, o) for o in within if o is not s)]


def test_no_profiler_enters_no_record_function(spec, model, track,
                                               monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("serve.poll") is spans.span("model.ffn")
    with spans.span("serve.poll"):
        pass
    _poll_once(model)
    _score(spec, track)


def test_poll_spans_nest_in_dispatch_order(model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _poll_once(model)
    got = _spans(prof)
    polls = [s for s in got if s[0] == "serve.poll"]
    assert len(polls) == 1
    kids = _children(got, polls[0])
    assert [s[0] for s in kids] == [
        "serve.due", "serve.pack", "serve.extend", "serve.due",
        "serve.pack", "serve.score", "serve.readback"]
    extend, score = kids[2], kids[5]
    # the CPU conv runs one row a call: one front-end a live segment
    assert {s[0] for s in _children(got, extend)} == {"model.frontend"}
    assert [s[0] for s in _children(got, score)] == [
        "model.encoder", "model.backend"]
    enc = _children(got, score)[0]
    assert [s[0] for s in _children(got, enc)] == ["model.ffn"] * LAYERS
    outside = [s for s in got if s[0].startswith("model.")
               and not (_inside(s, extend) or _inside(s, score))]
    assert outside == []


def test_score_dataset_spans_a_batch(spec, track):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _score(spec, track)
    got = _spans(prof)
    names = [s[0] for s in got]
    batches = 3
    for name, n in (("score.loader_wait", batches),
                    ("model.frontend", batches), ("model.encoder", batches),
                    ("model.ffn", batches * LAYERS),
                    ("model.backend", batches), ("score.readback", 1)):
        assert names.count(name) == n, name
    waits = [s for s in got if s[0] == "score.loader_wait"]
    fronts = [s for s in got if s[0] == "model.frontend"]
    for w, f in zip(waits, fronts):
        assert w[2] <= f[1]         # the batch is waited for, then scored
    encs = [s for s in got if s[0] == "model.encoder"]
    for ffn in (s for s in got if s[0] == "model.ffn"):
        assert any(_inside(ffn, e) for e in encs)
    readback, = [s for s in got if s[0] == "score.readback"]
    assert all(s[2] <= readback[1] for s in got if s is not readback)


def test_answers_do_not_depend_on_the_profiler(spec, model, track):
    _, plain_poll = _poll_once(model)
    plain_scores = _score(spec, track)
    with profile(activities=[ProfilerActivity.CPU]):
        _, traced_poll = _poll_once(model)
        traced_scores = _score(spec, track)
    assert traced_poll == plain_poll
    assert traced_scores == plain_scores


def test_export_under_a_profiler_enters_no_record_function(model,
                                                           monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered while exporting")

    wave = torch.zeros(2, DUR)
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        prog = torch.export.export(model, (wave,))
    torch.testing.assert_close(prog.module()(wave), model(wave), rtol=0,
                               atol=0)
