"""The port's RawBoost against the JAX package's, on the CPU.

Random draws cannot match across frameworks, so the deterministic cores
that take the draws as arguments (``firwin_bandstop``,
``notch_chain_from_params``, ``filter_fir``, ``norm_wav``,
``lnl_from_chains``, ``isd_from_params``, ``ssi_from_params``) get the same
numpy draws on both sides: the port's batched functions against the JAX
ones vmapped over the batch, within 1e-5. The sampled algorithms 1-8 are
held to their shapes, finite values and their generator: the same seed
gives the same batch. Three 0.25 s clips.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdsd_tpu_torch.ops import rawboost as rb

# the JAX package's ops/__init__ exports a function of the module's name
jrb = importlib.import_module("rtdsd_tpu.ops.rawboost")

FS = 16000.0
B, T = 3, 4000
ARGS = rb.RawBoostArgs()
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(rng, shape=(B,), g=(0.0, 0.0)):
    """One notch chain's draws per element of ``shape``: per band centre
    frequency, bandwidth and tap count (floored), and the gain."""
    nb = (ARGS.nBands,)
    return (rng.uniform(ARGS.minF, ARGS.maxF, shape + nb).astype(np.float32),
            rng.uniform(ARGS.minBW, ARGS.maxBW, shape + nb).astype(np.float32),
            np.floor(rng.uniform(ARGS.minCoeff, ARGS.maxCoeff, shape + nb)
                     ).astype(np.float32),
            rng.uniform(*g, shape).astype(np.float32))


def _chain_jax(fcs, bws, cs, g):
    return jax.vmap(lambda a, b, c, d: jrb.notch_chain_from_params(
        a, b, c.astype(jnp.int32), d, FS))(fcs, bws, cs, g)


def _chain_port(fcs, bws, cs, g):
    return rb.notch_chain_from_params(*map(torch.from_numpy, (fcs, bws, cs, g)),
                                      FS)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    t = np.arange(T) / FS
    x = (0.5 * np.sin(2 * np.pi * 300 * t)[None] * rng.uniform(0.5, 1.5, (B, 1))
         + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    return rng, x


def test_firwin_bandstop_matches_jax():
    rng = np.random.default_rng(1)
    c = (2 * rng.integers(5, 50, 6) + 1).astype(np.float32)
    f1 = rng.uniform(20, 3000, 6).astype(np.float32)
    f2 = (f1 + rng.uniform(100, 1000, 6)).astype(np.float32)
    want = jax.vmap(lambda a, b, d: jrb.firwin_bandstop(a, b, d, FS))(c, f1, f2)
    got = rb.firwin_bandstop(*map(torch.from_numpy, (c, f1, f2)), FS)
    _close(got, want)
    assert float(got[:, int(c.max()):].abs().max()) == 0.0


def test_notch_chain_matches_jax():
    draws = _draws(np.random.default_rng(2), g=(-20.0, -5.0))
    b_j, len_j = _chain_jax(*draws)
    b_p, len_p = _chain_port(*draws)
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    _close(b_p, b_j)


def test_filter_fir_and_norm_wav_match_jax(clips):
    rng, x = clips
    b, length = _chain_jax(*_draws(rng))
    want = jax.vmap(jrb.filter_fir)(x, b, length)
    got = rb.filter_fir(torch.from_numpy(x), torch.from_numpy(np.asarray(b)),
                        torch.from_numpy(np.asarray(length)).long())
    _close(got, want)
    for always in (False, True):
        _close(rb.norm_wav(got * 3, always),
               jax.vmap(lambda a: jrb.norm_wav(a, always))(want * 3))


def test_lnl_from_chains_matches_jax(clips):
    rng, x = clips
    draws = [_draws(rng, g=(0.0, 0.0) if i == 0 else (-20.0, -5.0))
             for i in range(ARGS.N_f)]
    chains_j = [_chain_jax(*d) for d in draws]
    want = jax.vmap(lambda xi, *cs: jrb.lnl_from_chains(
        xi, list(zip(cs[0::2], cs[1::2]))))(
        x, *[a for b, n in chains_j for a in (b, n)])
    got = rb.lnl_from_chains(torch.from_numpy(x),
                             [_chain_port(*d) for d in draws])
    _close(got, want)


def test_isd_from_params_matches_jax(clips):
    rng, x = clips
    selected = rng.uniform(size=(B, T)) < 0.05
    f_r = ((2 * rng.uniform(size=(B, T)) - 1)
           * (2 * rng.uniform(size=(B, T)) - 1)).astype(np.float32)
    want = jax.vmap(lambda a, s, f: jrb.isd_from_params(a, s, f, ARGS.g_sd))(
        x * 4, selected, f_r)
    got = rb.isd_from_params(torch.from_numpy(x * 4), torch.from_numpy(selected),
                             torch.from_numpy(f_r), ARGS.g_sd)
    _close(got, want)


def test_ssi_from_params_matches_jax(clips):
    rng, x = clips
    noise = rng.standard_normal((B, T)).astype(np.float32)
    b, length = _chain_jax(*_draws(rng))
    snr = rng.uniform(ARGS.SNRmin, ARGS.SNRmax, B).astype(np.float32)
    want = jax.vmap(jrb.ssi_from_params)(x, noise, b, length, snr)
    got = rb.ssi_from_params(
        torch.from_numpy(x), torch.from_numpy(noise),
        torch.from_numpy(np.asarray(b)), torch.from_numpy(np.asarray(length)),
        torch.from_numpy(snr))
    _close(got, want)


@pytest.mark.parametrize("algo", range(1, 9))
def test_sampled_algorithm(clips, algo):
    _, x = clips
    wave = torch.from_numpy(x)

    def run(seed):
        return rb.rawboost(wave, algo, torch.Generator().manual_seed(seed),
                           ARGS, FS)
    out = run(5)
    assert out.shape == wave.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, run(5))
    assert not torch.equal(out, run(6))
    assert not torch.equal(out, wave)


def test_isd_selects_exactly_n_samples(clips):
    _, x = clips
    wave = torch.from_numpy(np.full((B, T), 0.25, np.float32))
    gen = torch.Generator().manual_seed(3)
    out = rb.isd_additive_noise(gen, wave, ARGS)
    gen = torch.Generator().manual_seed(3)
    beta = rb._uniform(gen, (B,), 0.0, ARGS.P, "cpu")
    changed = (out != 0.25).sum(dim=-1)
    # f_r is never exactly 0, so every selected sample changes
    assert changed.tolist() == torch.floor(T * beta / 100).long().tolist()


def test_other_codes_are_the_identity(clips):
    _, x = clips
    wave = torch.from_numpy(x)
    for algo in (None, 0, 9):
        assert rb.rawboost(wave, algo, torch.Generator()) is wave
