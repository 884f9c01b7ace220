"""The port's augmentation chains against the JAX package's, on the CPU.

Device chain (``rtdsd_tpu_torch/ops/augment.py``): its deterministic cores
take the random draws as arguments, so each is held against the JAX
function vmapped over the same batch with the same numpy draws fed to it
(``jax.random``'s draw functions patched inside the traced function;
nothing of ``rtdsd_tpu`` changes), within 1e-5. The phase vocoder
``time_stretch`` is held to a quarter of float32's own error on it: both
packages accumulate phases of up to 2.5e4 rad in float32 (an ulp is 2e-3
rad there), so their float32 results lie about 1.6e-4 from the float64
one and ulp flips of the FFTs' rounding move them apart by about 2.5e-5.
The sampled chains: shapes, finite values, the same seed giving the same
batch, p = 0 the identity and p = 1 changing every row.

Host chain (``rtdsd_tpu_torch/data/host_augment.py``): numpy on both
sides, so the same ``numpy.random.Generator`` seed gives JAX's numbers bit
for bit; through the train loader on both decode paths too. The train
step runs RawBoost or the dataset-side chain, then pre-emphasis, then the
trainer-side chain.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdsd_tpu.ops import augment as jax_augment
from rtdsd_tpu_torch.data.io import write_wav
from rtdsd_tpu_torch.engine import steps
from rtdsd_tpu_torch.ops import augment

SR = 16000.0
B, T = 4, 8000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """Waves (sines in noise) and every core's draws, from one seed."""
    rng = np.random.default_rng(0)
    t = np.arange(T) / SR
    x = np.stack([0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
                  + 0.05 * rng.standard_normal(T) for i in range(B)])
    f32 = lambda a: np.asarray(a, np.float32)
    return {"x": f32(x), "apply": np.array([True, False, True, True]),
            "cutoff": f32(rng.uniform(20, 7500, B)),
            "white": f32(rng.standard_normal((B, T))),
            "f_decay": f32(rng.uniform(-2, 2, B)),
            "snr": f32(rng.uniform(10, 40, B)),
            "gain": f32(rng.uniform(-12, 12, B)),
            "frac": f32(rng.uniform(0.1, 0.15, B)),
            "start": rng.integers(0, T - int(0.15 * T), B).astype(np.int32),
            "rate": f32(rng.uniform(0.8, 1.2, B)),
            "distance": f32(rng.uniform(1, 20, B))}


def jax_core(fn, x, **draws):
    """``fn(key, x)`` of the JAX package vmapped over the batch, each
    ``jax.random.<name>`` call inside it returning the next of
    ``draws[name]`` (a tuple for several calls) for its row."""
    names = sorted(draws)

    def single(xi, *vals):
        queue = {k: list(v) if isinstance(v, tuple) else [v]
                 for k, v in zip(names, vals)}
        with pytest.MonkeyPatch.context() as mp:
            for k in names:
                mp.setattr(jax.random, k,
                           lambda *a, _k=k, **kw: queue[_k].pop(0))
            return fn(jax.random.key(0), xi)

    vals = [jax.tree_util.tree_map(jnp.asarray, draws[k]) for k in names]
    return np.asarray(jax.vmap(single)(jnp.asarray(x), *vals))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cores(d):
    """{case: (JAX result, port result)}, computed lazily."""
    x, ap = d["x"], d["apply"]
    fir = np.asarray(jax.vmap(lambda c: jax_augment.sinc_fir(c, SR, True))(
        d["cutoff"]))
    return {
        "sinc_fir_lowpass": lambda: (
            np.asarray(jax.vmap(lambda c: jax_augment.sinc_fir(c, SR, False))(
                d["cutoff"])), augment.sinc_fir(_t(d["cutoff"]), SR, False)),
        "sinc_fir_highpass": lambda: (
            fir, augment.sinc_fir(_t(d["cutoff"]), SR, True)),
        "fir_same": lambda: (
            np.asarray(jax.vmap(jax_augment._fir_same)(x, fir)),
            augment.fir_same(_t(x), _t(fir))),
        "colored_noise": lambda: (
            np.asarray(jax.vmap(_jax_shaped)(d["white"], d["f_decay"])),
            augment.colored_noise(_t(d["white"]), _t(d["f_decay"]), SR)),
        "add_colored_noise": lambda: (
            jax_core(lambda k, xi: jax_augment._add_colored_noise(
                k, xi, 0.5, SR, 10, 40, -2, 2), x, bernoulli=ap,
                uniform=(d["snr"], d["f_decay"]), normal=d["white"]),
            augment.add_colored_noise(
                _t(x), _t(ap), _t(d["snr"]),
                augment.colored_noise(_t(d["white"]), _t(d["f_decay"]), SR))),
        "gain": lambda: (
            jax_core(lambda k, xi: jax_augment._gain(k, xi, 0.75, -12, 12), x,
                     bernoulli=ap, uniform=d["gain"]),
            augment.gain(_t(x), _t(ap), _t(d["gain"]))),
        "time_mask": lambda: (
            jax_core(lambda k, xi: jax_augment._time_mask(k, xi, 0.5, 0.1,
                                                          0.15), x,
                     bernoulli=ap, uniform=d["frac"], randint=d["start"]),
            augment.time_mask(_t(x), _t(ap), _t(d["frac"]), _t(d["start"]))),
        "air_absorption": lambda: (
            jax_core(lambda k, xi: jax_augment.air_absorption(
                k, xi, 1.0, 20.0, SR), x, uniform=d["distance"]),
            augment.air_absorption(_t(x), _t(d["distance"]), SR)),
    }


def _jax_shaped(white, f_decay):
    """JAX's ``colored_noise`` given its white noise: the draw patched."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda *a, **k: white)
        return jax_augment.colored_noise(jax.random.key(0), T, f_decay, SR)


CORES = ("sinc_fir_lowpass", "sinc_fir_highpass", "fir_same",
         "colored_noise", "add_colored_noise", "gain", "time_mask",
         "air_absorption")


@pytest.mark.parametrize("case", CORES)
def test_core_matches_jax_vmapped(data, case):
    """Within 1e-5 of the output's scale: 1, or the largest |value| where
    that is larger (shaped noise before its SNR scaling reaches 9e3 at
    f_decay -2)."""
    want, got = _cores(data)[case]()
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_time_stretch_matches_jax_vmapped(data):
    want = jax_core(lambda k, xi: jax_augment.time_stretch(k, xi, 0.8, 1.2),
                    data["x"], uniform=data["rate"])
    got = augment.time_stretch(_t(data["x"]), _t(data["rate"])).numpy()
    exact = augment.time_stretch(_t(data["x"]).double(),
                                 _t(data["rate"]).double()).numpy()
    f32_err = float(np.abs(want - exact).max())
    gap = float(np.abs(got - want).max())
    assert got.shape == (B, T) and np.all(np.isfinite(got))
    assert 1e-5 < f32_err and gap <= 0.25 * f32_err, (gap, f32_err)
    # the frames past a rate above 1's end are zero in both
    assert np.array_equal(got[:, -1] == 0, want[:, -1] == 0)


def test_stft_framing_is_jaxs(data):
    """The vocoder's framing: JAX's own reflect-padded symmetric-Hann
    frames (not ``torch.stft``'s defaults), and its overlap-add inverse."""
    want = np.asarray(jax.vmap(lambda a: jax_augment._stft_frames(
        a, 1024, 256))(data["x"]))
    got = augment.stft_frames(_t(data["x"]), 1024, 256).numpy()
    assert got.shape == want.shape == (B, 1 + T // 256, 513)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    back = augment.istft_frames(_t(want), 1024, 256, T).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jax.vmap(lambda f: jax_augment._istft_frames(
            f, 1024, 256, T))(want)), rtol=0, atol=1e-5)


# ------------------------------------------------------- sampled chains

PRE = steps.pre_device_augs(["mul_augment"])
POST = steps.post_device_augs(["ACN", "HPF", "LPF", "GAN", "TMK"], True)


def _run(x, codes, seed):
    gen = torch.Generator().manual_seed(seed)
    return augment.augment(torch.from_numpy(x), codes, gen, SR)


@pytest.mark.parametrize("codes", [PRE, POST], ids=["mul_augment", "trainer"])
def test_chain_is_a_function_of_its_seed(data, codes):
    assert PRE == ("TST", "GAN", "AIR", "TMK")
    assert POST == ("ACN", "HPF", "LPF", "GAN", "TMK")
    a, b, c = (_run(data["x"], codes, s) for s in (3, 3, 4))
    assert a.shape == (B, T) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_chain_bernoulli_masks(data, monkeypatch, p):
    """p = 0 leaves every row as it was; p = 1 changes every row, code by
    code."""
    for code in ("ACN", "HPF", "LPF", "GAN", "TMK", "TST", "AIR"):
        monkeypatch.setitem(augment.DEFAULT_PARAMS, code,
                            {**augment.DEFAULT_PARAMS[code], "p": p})
        out = _run(data["x"], (code,), 7).numpy()
        changed = [not np.array_equal(out[i], data["x"][i]) for i in range(B)]
        assert changed == [p == 1.0] * B, code
    with pytest.raises(ValueError, match="unknown augmentation code"):
        _run(data["x"], ("XYZ",), 0)


def test_train_step_runs_the_chains_in_order(monkeypatch):
    """RawBoost or the dataset-side chain, then pre-emphasis, then the
    trainer-side chain, all drawing from the step's one generator."""
    from rtdsd_tpu_torch.models import registry, zoo

    calls = []
    real_aug, real_pre = steps.augment, steps.pre_emphasis
    monkeypatch.setattr(steps, "augment", lambda w, codes, g, sr: (
        calls.append(tuple(codes)), real_aug(w, codes, g, sr))[1])
    monkeypatch.setattr(steps, "pre_emphasis", lambda w, c: (
        calls.append("preemph"), real_pre(w, c))[1])
    spec = registry.get_model("My_XLSR_AASIST", remat=True, num_layers=1,
                              w2v={"encoder_embed_dim": 32,
                                   "encoder_ffn_dim": 64, "encoder_heads": 4,
                                   "conv_pos": 16, "conv_pos_groups": 4,
                                   "conv_layers": [[32, 10, 5], [32, 3, 2],
                                                   [32, 2, 2], [32, 2, 2]]})
    zoo.init_weights(spec.module, 0)
    state = steps.TrainState(spec.module, steps.make_optimizer(
        spec.module, 1e-3, 1e-4))
    waves = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, T)).astype(np.float32) * 0.3)
    labels = torch.tensor([0, 1, 1, 0])
    da = ["mul_augment", "ACN", "HPF", "LPF", "GAN", "TMK"]
    for algo, want in ((None, [PRE, "preemph", POST]),
                       (4, ["preemph", POST])):
        calls.clear()
        step = steps.make_train_step(
            rawboost_algo=algo,
            pre_aug_list=steps.pre_device_augs(da + ([f"RawBoost{algo}"]
                                                     if algo else [])),
            aug_list=steps.post_device_augs(da, True))
        loss = float(step(state, waves, labels, 1024)["loss"])
        assert calls == want and np.isfinite(loss)


# ------------------------------------------------------------ host chain

def _corpus(root):
    """Three noise files: 0.3 s (shorter than a clip: tiled), 1 s, and
    0.5 s at 22.05 kHz (resampled)."""
    rng = np.random.default_rng(9)
    root.mkdir(exist_ok=True)
    for name, n, sr in (("a.wav", 4800, 16000), ("b.flac", 16000, 16000),
                        ("c.wav", 11025, 22050)):
        write_wav(str(root / name), (0.1 * rng.standard_normal(n)).astype(
            np.float32), sr)
    return str(root)


def test_background_noise_matches_jax_bit_for_bit(tmp_path):
    from rtdsd_tpu.data import host_augment as jax_host
    from rtdsd_tpu_torch.data import host_augment

    corpus = _corpus(tmp_path / "noise")
    ours = host_augment.BackgroundNoiseCorpus(corpus)
    theirs = jax_host.BackgroundNoiseCorpus(corpus)
    assert [f[len(corpus):] for f in ours.files] == \
        [f[len(corpus):] for f in theirs.files]
    waves = np.random.default_rng(2).standard_normal((12, T)).astype(
        np.float32) * 0.2
    waves[3] = 0.0                                  # silent: left alone
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    mixed = 0
    for w in waves:
        a, b = ours(w, rng_a), theirs(w, rng_b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        mixed += not np.array_equal(a, w)
    assert 0 < mixed < len(waves)
    assert rng_a.random() == rng_b.random()       # the same draws taken


def test_host_chain_build_matches_jax(tmp_path):
    from rtdsd_tpu.data import host_augment as jax_host
    from rtdsd_tpu_torch.data import host_augment

    for mod in (host_augment, jax_host):
        with pytest.raises(FileNotFoundError, match="no"):
            mod.BackgroundNoiseCorpus(str(tmp_path))          # empty corpus
        assert not mod.mp3_codec_available()
        with pytest.raises(ImportError, match="codec"):
            mod.Mp3Compression()
        with pytest.warns(UserWarning, match="no MP3 codec"):
            assert mod.build_host_chain("", 16000) is None
    corpus = _corpus(tmp_path / "noise")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = host_augment.build_host_chain(corpus, 16000)
        theirs = jax_host.build_host_chain(corpus, 16000)
    assert [type(t).__name__ for t in ours.transforms] == \
        [type(t).__name__ for t in theirs.transforms] == \
        ["BackgroundNoiseCorpus"]
    w = np.random.default_rng(3).standard_normal(T).astype(np.float32)
    assert np.array_equal(ours(w, np.random.default_rng(1)),
                          theirs(w, np.random.default_rng(1)))


@pytest.mark.parametrize("native", [True, False])
def test_train_loader_applies_host_chain_as_jax(tmp_path, native):
    """``mul_augment`` with a noise corpus: the train set carries the host
    chain and both loader paths apply it after the crop, batch for batch
    equal to the JAX loader's; a RawBoost code takes priority (no chain)."""
    from rtdsd_tpu.config import load_yaml_config as jax_load
    from rtdsd_tpu.data.dataset import ASVspoof2019LA as JaxLA
    from rtdsd_tpu.data.loader import DataLoader as JaxLoader
    from rtdsd_tpu.native import flac as jax_flac
    from rtdsd_tpu_torch.config import load_yaml_config
    from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA
    from rtdsd_tpu_torch.data.loader import DataLoader
    from _torch_track import write_split

    assert jax_flac.build_if_needed()
    (tmp_path / "audio").mkdir()
    rng = np.random.default_rng(6)
    train = write_split(tmp_path, "LA_T", 8, rng)
    audio = str(tmp_path / "audio")
    cfg = {"SysConfig": {"path_label_asv_spoof_2019_la_train": train,
                         "path_asv_spoof_2019_la_train": audio,
                         "noise_path": _corpus(tmp_path / "noise")},
           "ExpConfig": {"random_seed": 11, "train_duration_sec": 0.5,
                         "is_random_start": True,
                         "data_augmentation": ["mul_augment", "ACN"]}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # no MP3 codec here
        ours_ds = ASVspoof2019LA(*load_yaml_config(str(path)), is_train=True)
        theirs_ds = JaxLA(*jax_load(str(path)), is_train=True)
    assert ours_ds.host_augment is not None
    ours = DataLoader(ours_ds, 4, shuffle=True, drop_last=True, seed=11,
                      num_workers=2, use_native=native)
    theirs = JaxLoader(theirs_ds, 4, shuffle=True, drop_last=True, seed=11,
                       num_workers=2, use_native=native)
    for x, y in zip(list(ours), list(theirs)):
        assert x.utt_ids == y.utt_ids
        np.testing.assert_array_equal(x.waves, y.waves)
    cfg["ExpConfig"]["data_augmentation"] += ["RawBoost2"]
    path.write_text(json.dumps(cfg))
    assert ASVspoof2019LA(*load_yaml_config(str(path)),
                          is_train=True).host_augment is None
