"""PyTorch port, RNS/RRNS slice: residue arithmetic, the residue kernels'
plain versions, the analog channel, the RRNS decode, stationary encoding,
the health counters and the RNS GEMM backends, each against the JAX package
on numpy-seeded inputs.

Randomness: the port's stochastic stages take named draws
(``repro_torch.analog.channel.Draws``); :class:`Replay` hands them the
exact arrays the JAX code draws, by repeating its key splits
(``mirage_rrns.py:132-136``, ``channel.py:268-277``), so the two packages
are held bit for bit on residues, decodes and counters. Outputs after the
cross-group f32 sum are held to ``rtol = 2e-5`` (only the order of that sum
differs), and bitwise where there is a single group.

Kernel-vs-plain checks on the card carry the ``cuda`` marker and skip here
(``python3 chip_smoke.py`` runs them at the serving shapes).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.analog import channel as jchannel
from repro.analog import rrns as jrrns
from repro.core import gemm as jgemm
from repro.core import noise as jnoise
from repro.core import rns as jrns
from repro.core import stationary as jstationary
from repro.core.backends import mirage_rrns as jmirage_rrns
from repro.core.precision import get_policy as jpolicy
from repro.kernels import ops as jops
from repro.kernels.rrns_decode import rrns_decode_pallas
from repro.obs import health as jhealth
from repro_torch.analog import channel, rrns
from repro_torch.core import backends, gemm, noise, rns, stationary
from repro_torch.core.backends import grouped
from repro_torch.core.backends import mirage_rrns as tmirage_rrns
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ops, ref
from repro_torch.obs import health


class Replay:
    """Draws that replay the JAX package's for the same stage names."""

    def __init__(self, keys):
        self.keys = keys

    def normal(self, stage, shape):
        return torch.from_numpy(np.asarray(
            jax.random.normal(self.keys[stage], shape)))

    def uniform(self, stage, shape):
        return torch.from_numpy(np.asarray(
            jax.random.uniform(self.keys[stage], shape)))

    def randint(self, stage, shape, low, high):
        return torch.from_numpy(np.asarray(
            jax.random.randint(self.keys[stage], shape, low, high)))


def channel_replay(key, n_moduli):
    """The stage keys ``_analog_forward`` splits from a GEMM's key."""
    k_prog, k_det, k_burst = jax.random.split(key, 3)
    k_hit, k_pos, k_err = jax.random.split(k_burst, 3)
    keys = {"drift": k_prog, "detector": k_det, "burst_hit": k_hit,
            "burst_pos": k_pos}
    for i in range(n_moduli):
        keys[f"burst_err/{i}"] = jax.random.fold_in(k_err, i)
    return Replay(keys)


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, m, size=shape)
                     for m in moduli]).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rrns_setup(k):
    base = (2**k - 1, 2**k, 2**k + 1)
    allm = base + jrrns.default_redundant_moduli(k)
    psi = (int(np.prod(base)) - 1) // 2
    return allm, psi


def _corrupt(allm, psi, seed, size=120):
    """Residues of legal values (psi edges included) with 0, 1 or 2 residue
    errors at known places, then random tuples."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-psi, psi + 1, size=size)
    xs[:6] = [psi, -psi, 0, psi - 1, 1 - psi, 1]
    res = np.stack([np.mod(xs, m) for m in allm]).astype(np.int64)
    n_err = np.arange(size) % 3                    # 0, 1, 2 errors
    for j in range(size):
        for i in rng.choice(len(allm), size=n_err[j], replace=False):
            res[i, j] = (res[i, j] + rng.integers(1, allm[i])) % allm[i]
    rand = np.stack([rng.integers(0, m, size=size // 2) for m in allm])
    return np.concatenate([res, rand], axis=1).astype(np.int32)


# --------------------------------------------------------------------------
# core/rns.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5, 8])
def test_rns_conversions_bitwise_over_signed_range(k):
    M = (2**k - 1) * 2**k * (2**k + 1)
    psi = (M - 1) // 2
    xs = np.arange(-psi, psi + 1, dtype=np.int64)
    if xs.size > 200_000:
        xs = np.concatenate([xs[:50_000], xs[-50_000:],
                             np.random.default_rng(k).choice(xs, 100_000)])
    xs = xs.astype(np.int32)
    moduli = (2**k - 1, 2**k, 2**k + 1)
    want_g = np.asarray(jrns.to_rns(jnp.asarray(xs), moduli))
    want_s = np.asarray(jrns.to_rns_special(jnp.asarray(xs), k))
    got_g = rns.to_rns(_t(xs), moduli).numpy()
    got_s = rns.to_rns_special(_t(xs), k).numpy()
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_s, got_g)
    back = rns.from_rns_special(_t(got_s), k).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jrns.from_rns_special(jnp.asarray(want_s), k)))
    np.testing.assert_array_equal(back, xs)
    # float mantissas (the BFP operands) convert like their integers
    np.testing.assert_array_equal(
        rns.to_rns(_t(xs[:999].astype(np.float32)), moduli).numpy(),
        want_g[:, :999])
    assert rns.crt_constants(moduli) == jrns.crt_constants(moduli)


@pytest.mark.parametrize("m,K", [(33, 40), (257, 300)])
def test_mod_matmul_bitwise(m, K):
    """K = 300 at m = 257 exceeds the f32 window (cap 255): chunked."""
    x, w = _residues((m,), (6, K), 1)[0], _residues((m,), (K, 5), 2)[0]
    want = np.asarray(jrns.mod_matmul(jnp.asarray(x), jnp.asarray(w), m))
    got = rns.mod_matmul(_t(x), _t(w), m).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (x.astype(np.int64) @ w) % m)
    mods = (31, 32, 33)
    xs, ws = _residues(mods, (4, 20), 3), _residues(mods, (20, 7), 4)
    np.testing.assert_array_equal(
        rns.rns_matmul(_t(xs), _t(ws), mods).numpy(),
        np.asarray(jrns.rns_matmul(jnp.asarray(xs), jnp.asarray(ws), mods)))


def test_exact_mod_and_grouped_residue_dot_bitwise():
    a = np.arange(0, 1 << 24, 4099, dtype=np.float32)
    for m in (31, 37, 41, 257):
        np.testing.assert_array_equal(
            grouped.exact_mod(_t(a), m).numpy(), np.mod(a, m))
    # g = 300 at m = 257 splits the group dot (cap 255)
    for m, g in ((41, 16), (257, 300)):
        x, w = _residues((m,), (3, 4, g), 5)[0], _residues((m,), (3, g, 6),
                                                          6)[0]
        from repro.core.backends import grouped as jgrouped
        want = np.asarray(jgrouped.grouped_residue_dot(
            jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32), m))
        np.testing.assert_array_equal(
            grouped.grouped_residue_dot(_t(x), _t(w), m).numpy(), want)


# --------------------------------------------------------------------------
# kernels 4 and 5: plain versions vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

RNS_CASES = {"base": (31, 32, 33), "rrns": (31, 32, 33, 37, 41),
             "k8": (255, 256, 257)}


@pytest.mark.parametrize("case", sorted(RNS_CASES))
def test_rns_matmul_plain_matches_pallas(case):
    moduli = RNS_CASES[case]
    G, M, g, N = 3, 5, 16, 9
    x = _residues(moduli, (G, M, g), 7)
    w = _residues(moduli, (G, g, N), 8)
    want = np.asarray(jops.rns_group_matmul(jnp.asarray(x), jnp.asarray(w),
                                            moduli, interpret=True))
    got = ops.rns_group_matmul(_t(x), _t(w), moduli).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("adc_bits", [None, 4])
def test_rns_matmul_channel_plain_matches_pallas(adc_bits):
    moduli = RNS_CASES["rrns"]
    G, M, g, N = 2, 4, 16, 7
    x = _residues(moduli, (G, M, g), 9)
    w = _residues(moduli, (G, g, N), 10)
    sig = np.asarray([0.8, 0.5, 3.0, 0.2, 1.1], np.float32)
    nz = (_rand((len(moduli), G, M, N), 11) * sig[:, None, None, None])
    want = np.asarray(jops.rns_group_matmul_channel(
        jnp.asarray(x), jnp.asarray(w), moduli, jnp.asarray(nz),
        adc_bits=adc_bits, interpret=True))
    got = ops.rns_group_matmul_channel(_t(x), _t(w), moduli, _t(nz),
                                       adc_bits=adc_bits).numpy()
    np.testing.assert_array_equal(got, want)
    clean = ref.rns_matmul_ref(_t(x), _t(w), moduli).numpy()
    assert (got != clean).any()                    # the noise moved some


# --------------------------------------------------------------------------
# kernel 6: the RRNS decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 6])
def test_rrns_decode_plain_matches_jax_and_oracle(k):
    """k = 5: the f32 path, against the Pallas kernel, the fused jnp decode
    and the python-int oracle; k = 6: the int32 fallback (not f32-exact),
    against the jnp decode and the oracle."""
    allm, psi = _rrns_setup(k)
    tables = rrns.build_tables(allm, 3, psi)
    jt = jrrns.build_tables(allm, 3, psi)
    assert tables.f32_exact == jt.f32_exact == (k == 5)
    assert (tables.n_subsets, tables.binom, tables.vote_threshold) == \
        (jt.n_subsets, jt.binom, jt.vote_threshold)
    res = _corrupt(allm, psi, seed=k)
    dec, cor = rrns.rrns_decode(_t(res), tables)
    dec, cor = dec.numpy(), cor.numpy()
    w_dec, w_cor = jrrns.rrns_decode(jnp.asarray(res), jt)
    np.testing.assert_array_equal(dec, np.asarray(w_dec))
    np.testing.assert_array_equal(cor, np.asarray(w_cor))
    if k == 5:
        p_dec, p_cor = rrns_decode_pallas(jnp.asarray(res), jt, block_e=64,
                                          interpret=True)
        np.testing.assert_array_equal(dec, np.asarray(p_dec))
        np.testing.assert_array_equal(cor, np.asarray(p_cor))
    o_dec, o_cor = noise.rrns_decode_np(res, allm, 3, psi)
    np.testing.assert_array_equal(dec, o_dec)
    np.testing.assert_array_equal(cor, o_cor)
    # the first 120 columns: 0 errors decode clean, 1 error is corrected
    n_err = np.arange(120) % 3
    xs_dec = dec[:120]
    assert not cor[:120][n_err == 0].any()
    assert cor[:120][n_err == 1].all()
    ref_dec, ref_cor = rrns.rrns_decode_reference(_t(res), tables)
    np.testing.assert_array_equal(ref_dec.numpy(), dec)
    np.testing.assert_array_equal(ref_cor.numpy(), cor)
    assert xs_dec.dtype == np.int32


def test_rrns_decode_votes_and_tables_match_jax():
    allm, psi = _rrns_setup(5)
    assert allm == (31, 32, 33, 37, 41)
    t, jt = rrns.build_tables(allm, 3, psi), jrrns.build_tables(allm, 3, psi)
    for f in ("weights", "subset_M", "subset_psi", "members", "comp"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f))
    assert (t.n_subsets, t.binom, t.vote_threshold) == (10, (1, 4, 10), 4)
    words = ops._rrns_table_words(t)
    assert words.dtype == np.float32 and words.size == 797
    res = _corrupt(allm, psi, seed=3)
    dec, votes = ref.rrns_decode_ref(_t(res), t)
    # votes: S for no error, 4 for one corrected error, -1 never (legal)
    v = votes.numpy()[:120]
    n_err = np.arange(120) % 3
    assert (v[n_err == 0] == 10).all() and (v[n_err == 1] == 4).all()
    assert set(np.unique(votes.numpy())) <= {-1.0, 1.0, 4.0, 10.0}


@pytest.mark.parametrize("k", [5, 6])
def test_rrns_votes_rise_strictly(k):
    """The decode kernel stops at the first subset with the largest vote;
    that keeps the first strict maximum only while binom rises strictly.
    k = 5 is the paper point (31, 32, 33, 37, 41) that chip_smoke.py and the
    tests above build; k = 6 the set of the int32 fallback."""
    allm, psi = _rrns_setup(k)
    t = rrns.build_tables(allm, 3, psi)
    assert all(a < b for a, b in zip(t.binom, t.binom[1:]))
    words = ops._host_tables(allm, 3, psi)
    assert words.device.type == "cpu" and words.numel() == 797
    n_total, n_required = len(allm), 3
    assert float(words[512 + 256 + 16 + n_total - n_required]) == \
        t.binom[-1] == t.n_subsets


def _kernel_decode(res, tables):
    """numpy f32 emulation of csrc/rrns_decode.cu on the table words the
    kernel receives (rns.cuh field order): per element the subsets in order
    until the first one with the largest vote, each f32 operation rounded
    once as the kernel's __*_rn intrinsics. Returns (decoded, votes,
    subsets evaluated per element)."""
    w = ops._rrns_table_words(tables)
    weight = w[:512].reshape(64, 8)
    sub_M, sub_inv, sub_psi, sub_lo = w[512:768].reshape(4, 64)
    mod, inv_mod = w[768:784].reshape(2, 8)
    binom, (psi, n_total, n_required, n_subsets) = w[784:793], w[793:797]
    n_total, n_required = int(n_total), int(n_required)
    r = res.astype(np.float32)
    E = r.shape[1]
    v_max = binom[n_total - n_required]
    best_v = np.full(E, -2.0, np.float32)
    best_x = np.zeros(E, np.float32)
    evaluated = np.zeros(E, np.int64)
    for s in range(int(n_subsets)):
        live = best_v < v_max
        if not live.any():
            break
        evaluated += live
        acc = r[0] * weight[s, 0]
        for i in range(1, n_total):
            acc = acc + r[i] * weight[s, i]
        q = np.floor(acc * sub_inv[s] + np.float32(0.5))
        X = acc - q * sub_M[s]
        X = np.where(X > sub_psi[s], X - sub_M[s], X)
        X = np.where(X < sub_lo[s], X + sub_M[s], X)
        cons = np.zeros(E, np.int64)
        for i in range(n_total):
            d = X - r[i]
            cons += (d - np.rint(d * inv_mod[i]) * mod[i]) == 0
        v = binom[np.maximum(cons - n_required, 0)]
        v = np.where(np.abs(X) <= psi, v, np.float32(-1.0))
        better = live & (v > best_v)
        best_v = np.where(better, v, best_v)
        best_x = np.where(better, X, best_x)
    dec = np.where(best_v >= 0, best_x, 0).astype(np.int32)
    return dec, best_v, evaluated


def _subset0_faults(allm, psi, seed, size=300):
    """Legal values with one or two errors on subset 0's moduli at random
    elements, so no faulty element stops before the last subset."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-psi, psi + 1, size=size)
    res = np.stack([np.mod(xs, m) for m in allm]).astype(np.int64)
    n_err = rng.integers(0, 3, size=size)
    for j in range(size):
        for i in rng.choice(3, size=n_err[j], replace=False):
            res[i, j] = (res[i, j] + rng.integers(1, allm[i])) % allm[i]
    return res.astype(np.int32), n_err


@pytest.mark.parametrize("case", ["corrupt-3", "corrupt-4", "corrupt-5",
                                  "subset0-6", "subset0-7"])
def test_rrns_decode_early_stop_emulation_matches_plain(case):
    """The kernel's loop with its early stop equals decode_votes (its plain
    version) bit for bit in values and votes, with 0, 1 and 2 injected
    errors; error-free elements evaluate subset 0 alone, and elements with
    an error run every subset."""
    allm, psi = _rrns_setup(5)
    tables = rrns.get_tables(allm, 3, psi)
    kind, seed = case.split("-")
    if kind == "corrupt":
        res = _corrupt(allm, psi, seed=int(seed))
        n_err = np.concatenate([np.arange(120) % 3, np.full(60, -1)])
    else:
        res, n_err = _subset0_faults(allm, psi, seed=int(seed))
    dec, votes, evaluated = _kernel_decode(res, tables)
    want_dec, want_votes = ref.rrns_decode_ref(_t(res), tables)
    np.testing.assert_array_equal(dec, want_dec.numpy())
    np.testing.assert_array_equal(votes.view(np.int32),
                                  want_votes.numpy().view(np.int32))
    assert (evaluated[n_err == 0] == 1).all()
    assert (evaluated[n_err > 0] == tables.n_subsets).all()


# --------------------------------------------------------------------------
# analog channel stages, with replayed draws, and their health counters
# --------------------------------------------------------------------------

def _both_recorded(fn_t, fn_j):
    with health.collect() as hc:
        got = fn_t()
    with jhealth.collect() as jc:
        want = fn_j()
    rec = {k: np.asarray(v.numpy()) for k, v in hc.values.items()}
    jrec = {k: np.asarray(v) for k, v in jc.values.items()}
    return got, want, rec, jrec


@pytest.mark.parametrize("stage", ["dac", "phase", "crosstalk2",
                                   "crosstalk4", "burst", "program",
                                   "readout"])
def test_channel_stage_bitwise_with_replayed_draws(stage):
    moduli = RNS_CASES["rrns"]
    G = 2 if stage == "crosstalk2" else 4
    res = _residues(moduli, (G, 3, 5), 12)
    key = jax.random.PRNGKey(21)
    draws = channel_replay(key, len(moduli))
    k_prog, k_det, k_burst = jax.random.split(key, 3)
    r_t, r_j = _t(res), jnp.asarray(res)
    cfg_kw = dict(dac_bits=4, adc_bits=4, snr_db=24.0, noise_sigma=0.3,
                  phase_drift_sigma=0.9, crosstalk=0.07, burst_rate=0.3,
                  burst_width=2)
    cfg, jcfg = (channel.AnalogChannelConfig(**cfg_kw),
                 jchannel.AnalogChannelConfig(**cfg_kw))
    sig = cfg.detector_sigmas(moduli)
    assert sig == jcfg.detector_sigmas(moduli)
    fns = {
        "dac": (lambda: channel.converter_quantize(r_t, moduli, 4),
                lambda: jchannel.converter_quantize(r_j, moduli, 4)),
        "phase": (lambda: channel.phase_noise(r_t, moduli, sig, draws),
                  lambda: jchannel.phase_noise(r_j, moduli, sig, k_det)),
        "crosstalk2": (lambda: channel.crosstalk_mix(r_t, moduli, 0.3),
                       lambda: jchannel.crosstalk_mix(r_j, moduli, 0.3)),
        "crosstalk4": (lambda: channel.crosstalk_mix(r_t, moduli, 0.21),
                       lambda: jchannel.crosstalk_mix(r_j, moduli, 0.21)),
        "burst": (lambda: channel.burst_errors(r_t, moduli, 0.3, 2, draws),
                  lambda: jchannel.burst_errors(r_j, moduli, 0.3, 2,
                                                k_burst)),
        "program": (lambda: channel.apply_program_channel(r_t, moduli, cfg,
                                                          draws),
                    lambda: jchannel.apply_program_channel(r_j, moduli, jcfg,
                                                           k_prog)),
        "readout": (lambda: channel.apply_readout_channel(r_t, moduli, cfg,
                                                          draws),
                    lambda: jchannel.apply_readout_channel(r_j, moduli, jcfg,
                                                           k_det)),
    }
    got, want, rec, jrec = _both_recorded(*fns[stage])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert rec.keys() == jrec.keys()
    for name in rec:
        np.testing.assert_array_equal(rec[name], jrec[name])
    if stage in ("burst", "program", "readout"):
        assert rec                                   # a counter was recorded


def test_noise_helpers_match_jax():
    moduli = (31, 32, 33)
    res = _residues(moduli, (4, 6), 13)
    key = jax.random.PRNGKey(5)
    got = noise.inject_phase_noise(_t(res), moduli, 0.7,
                                   Replay({"detector": key}))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnoise.inject_phase_noise(
            jnp.asarray(res), moduli, 0.7, key)))
    assert noise.snr_requirement_db(41) == jnoise.snr_requirement_db(41)
    assert channel.detector_sigma_levels(41, 52.0) == \
        jchannel.detector_sigma_levels(41, 52.0)


# --------------------------------------------------------------------------
# stationary encoding, health spec, policy fields
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,kw", [
    ("mirage_rns", {}),
    ("mirage_rrns", {}),
    ("mirage_rrns", dict(dac_bits=4, phase_drift_sigma=0.8)),
    ("mirage_rns_noisy", dict(phase_drift_sigma=0.5)),
])
def test_encode_stationary_bitwise(mode, kw):
    w = _rand((37, 20), 14, 0.3)                    # ragged K: padded group
    key = jax.random.PRNGKey(8)
    want = jstationary.encode_stationary(jnp.asarray(w), jpolicy(mode, **kw),
                                         key=key)
    got = stationary.encode_stationary(_t(w), get_policy(mode, **kw),
                                       draws=Replay({"drift": key}))
    np.testing.assert_array_equal(got.residues.numpy(),
                                  np.asarray(want.residues))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.moduli, got.b_m, got.g, got.orig_k) == \
        (want.moduli, want.b_m, want.g, want.orig_k)


@pytest.mark.parametrize("mode,kw", [
    ("mirage_fast", {}), ("mirage_rns", {}), ("mirage_rns_noisy", {}),
    ("mirage_rrns", {}), ("mirage_rrns", dict(snr_db=30.0)),
    ("mirage_rns_noisy", dict(snr_db=20.0, phase_drift_sigma=0.1,
                              burst_rate=0.01)),
    ("mirage_rrns_ref", dict(noise_sigma=0.2)),
])
def test_health_spec_and_policy_fields_match_jax(mode, kw):
    p, jp = get_policy(mode, **kw), jpolicy(mode, **kw)
    assert health.spec(p) == jhealth.spec(jp)
    assert (p.all_moduli, p.psi, p.converter_bits, p.moduli) == \
        (jp.all_moduli, jp.psi, jp.converter_bits, jp.moduli)
    assert rrns.rrns_moduli(p) == jrrns.rrns_moduli(jp)
    assert stationary.stationary_moduli(p) == \
        jstationary.stationary_moduli(jp)


# --------------------------------------------------------------------------
# the RNS GEMM backends against the JAX package
# --------------------------------------------------------------------------

BACKEND_CASES = [
    ("mirage_rns", {}, 16),
    ("mirage_rns", {}, 80),
    ("mirage_rns", dict(noise_sigma=0.4), 16),
    ("mirage_rns", dict(group_block=2), 80),       # the blocked CPU regime
    ("mirage_rns_pallas", {}, 16),
    ("mirage_rns_noisy", dict(snr_db=26.0, adc_bits=4, dac_bits=4), 16),
    ("mirage_rns_noisy", dict(crosstalk=0.05, phase_drift_sigma=0.3), 48),
    ("mirage_rrns", {}, 16),
    ("mirage_rrns", dict(snr_db=22.0), 16),
    ("mirage_rrns", dict(snr_db=22.0), 80),
    ("mirage_rrns", dict(snr_db=30.0, burst_rate=0.02, burst_width=1,
                         adc_bits=5), 16),
    ("mirage_rrns_ref", dict(snr_db=22.0), 80),
]


@pytest.mark.parametrize("mode,kw,K", BACKEND_CASES)
def test_backend_matches_jax(mode, kw, K):
    """Same inputs and draws: equal health counters, and outputs equal
    bitwise at one group (K = 16), within the f32 sum order otherwise."""
    x, w = _rand((2, 3, K), 15), _rand((K, 11), 16, 0.2)
    key = jax.random.PRNGKey(17)
    with jhealth.collect() as jc:
        want = np.asarray(jgemm.mirage_matmul_nograd(
            jnp.asarray(x), jnp.asarray(w), jpolicy(mode, **kw), key=key))
    jvals = jc.values
    draws = Replay({"detector": key}) if mode == "mirage_rns" else \
        channel_replay(key, len(rrns.rrns_moduli(get_policy(mode, **kw))
                                if "rrns" in mode else (31, 32, 33)))
    with health.collect() as hc:
        got = gemm.mirage_matmul_nograd(_t(x), _t(w), get_policy(mode, **kw),
                                        draws=draws).numpy()
    assert got.shape == want.shape == (2, 3, 11)
    if K == 16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())
    assert hc.values.keys() == jvals.keys()
    for name, v in hc.values.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jvals[name]))


def test_backend_residues_and_crt_bitwise():
    """Inside the GEMM: the residue tensor after the channel and its CRT
    (decoded) values equal the JAX package's, bit for bit."""
    p, jp = get_policy("mirage_rrns", snr_db=22.0), \
        jpolicy("mirage_rrns", snr_db=22.0)
    moduli = rrns.rrns_moduli(p)
    # the inputs of a test_backend_matches_jax case, whose ops JAX has
    # compiled already
    x, w = _rand((2, 3, 80), 15), _rand((80, 11), 16, 0.2)
    key = jax.random.PRNGKey(17)
    draws = channel_replay(key, len(moduli))
    k_prog, k_det, _ = jax.random.split(key, 3)
    cfg = channel.AnalogChannelConfig.from_policy(p)
    jcfg = jchannel.AnalogChannelConfig.from_policy(jp)
    xr, wr, _, _, _ = tmirage_rrns._prepare(_t(x), _t(w), p, moduli, cfg,
                                            draws, True)
    jxr, jwr, _, _, _ = jmirage_rrns._prepare(jnp.asarray(x), jnp.asarray(w),
                                              jp, moduli, jcfg, k_prog, True)
    np.testing.assert_array_equal(xr.numpy(), np.asarray(jxr))
    res = channel.apply_readout_channel(grouped.residue_dots(xr, wr, moduli),
                                        moduli, cfg, draws)
    jres = jchannel.apply_readout_channel(
        jmirage_rrns._residue_dots_jnp(jxr, jwr, moduli), moduli, jcfg, k_det)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    tables = rrns.get_tables(moduli, 3, p.psi)
    dec, _ = rrns.rrns_decode(res, tables)
    jdec, _ = jrrns.rrns_decode(jres, jrrns.get_tables(moduli, 3, jp.psi))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    crt = rns.from_rns_special(res[:3], 5)
    np.testing.assert_array_equal(
        crt.numpy(), np.asarray(jrns.from_rns_special(jres[:3], 5)))


def test_stationary_weight_runs_like_per_call():
    x, w = _rand((5, 64), 20), _rand((64, 10), 21, 0.2)
    for mode in ("mirage_rns", "mirage_rrns"):
        p = get_policy(mode)
        sr = stationary.encode_stationary(_t(w), p)
        np.testing.assert_array_equal(
            gemm.mirage_matmul_nograd(_t(x), sr, p).numpy(),
            gemm.mirage_matmul_nograd(_t(x), _t(w), p).numpy())
    with pytest.raises(TypeError, match="supports_stationary_residues"):
        gemm.mirage_matmul_nograd(_t(x), sr, get_policy("mirage"))
    with pytest.raises(ValueError, match="moduli"):
        gemm.mirage_matmul_nograd(_t(x), sr, get_policy("mirage_rns"))
    with pytest.raises(ValueError, match="K=64"):
        gemm.mirage_matmul_nograd(_t(x[:, :32]), sr, get_policy("mirage_rrns"))


def test_prequantized_weight_rns_gemm_bitwise():
    """The weight-stationary contract: an on-grid weight decomposes exactly
    (``bfp_decompose_contract``) and the RNS GEMM under
    ``assume_quantized_weights`` equals the JAX package's."""
    from repro.core import bfp as jbfp
    from repro_torch.core import bfp
    # the shapes of a test_backend_matches_jax case, whose ops JAX has
    # compiled already
    w = np.asarray(jbfp.bfp_fake_quant(jnp.asarray(_rand((11, 80), 24)),
                                       4, 16).T)        # (K, N), on-grid
    for got, want in zip(bfp.bfp_decompose_contract(_t(w), 4, 16),
                         jbfp.bfp_decompose_contract(jnp.asarray(w), 4, 16)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = _rand((2, 3, 80), 25)
    kw = dict(assume_quantized_weights=True)
    np.testing.assert_array_equal(
        gemm.mirage_matmul_nograd(_t(x), _t(w),
                                  get_policy("mirage_rns", **kw)).numpy(),
        np.asarray(jgemm.mirage_matmul_nograd(
            jnp.asarray(x), jnp.asarray(w), jpolicy("mirage_rns", **kw))))


def test_stochastic_backend_draw_sources():
    """Explicit draws, the ambient scope, noise_seed, or an error — and the
    scope's generator advances, so two GEMMs under it draw fresh noise."""
    x, w = _t(_rand((3, 32), 22)), _t(_rand((32, 8), 23, 0.2))
    p = get_policy("mirage_rns_noisy", snr_db=18.0)
    with pytest.raises(ValueError, match="no randomness"):
        gemm.mirage_matmul_nograd(x, w, p)
    with pytest.raises(ValueError, match="requires draws"):
        gemm.mirage_matmul_nograd(x, w, get_policy("mirage_rns",
                                                   noise_sigma=0.5))
    gen = torch.Generator().manual_seed(0)
    with gemm.noise_scope(gen):
        a = gemm.mirage_matmul_nograd(x, w, p)
        b = gemm.mirage_matmul_nograd(x, w, p)
    assert not torch.equal(a, b)
    gen2 = torch.Generator().manual_seed(0)
    with gemm.noise_scope(gen2):
        a2 = gemm.mirage_matmul_nograd(x, w, p)
    assert torch.equal(a, a2)
    seeded = p.replace(noise_seed=4)
    assert torch.equal(gemm.mirage_matmul_nograd(x, w, seeded),
                       gemm.mirage_matmul_nograd(x, w, seeded))
    assert tmirage_rrns._dims_tag(((3, 32), (32, 8))) == \
        jmirage_rrns._dims_tag(((3, 32), (32, 8)))


def test_unported_rns_pieces_raise():
    # the fault controls are ported (slice 7): an inert scope opens
    with channel.fault_scope(None):
        assert channel.fault_controls() is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.rns_residue_matmul()
    for mode in ("mirage_rns", "mirage_rns_pallas", "mirage_rns_noisy",
                 "mirage_rrns", "mirage_rrns_ref"):
        assert backends.resolve(get_policy(mode)).supports_noise


# --------------------------------------------------------------------------
# on the card: each residue kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RNS_CASES))
def test_cuda_rns_matmul_kernel_vs_plain(cuda, case):
    moduli = RNS_CASES[case]
    for G, M, g, N in ((56, 4, 16, 896), (3, 37, 16, 130), (2, 5, 40, 9)):
        x = _t(_residues(moduli, (G, M, g), 1)).to(cuda)
        w = _t(_residues(moduli, (G, g, N), 2)).to(cuda)
        assert torch.equal(ops.rns_group_matmul(x, w, moduli),
                           ref.rns_matmul_ref(x, w, moduli))


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits", [None, 4, 5])
def test_cuda_rns_matmul_channel_kernel_vs_plain(cuda, adc_bits):
    moduli = RNS_CASES["rrns"]
    x = _t(_residues(moduli, (7, 20, 16), 3)).to(cuda)
    w = _t(_residues(moduli, (7, 16, 300), 4)).to(cuda)
    nz = _t(_rand((5, 7, 20, 300), 5, 0.8)).to(cuda)
    assert torch.equal(
        ops.rns_group_matmul_channel(x, w, moduli, nz, adc_bits),
        ref.rns_matmul_channel_ref(x, w, moduli, nz, adc_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["corrupt-3000", "corrupt-3001",
                                  "subset0-4001"])
def test_cuda_rrns_decode_kernel_vs_plain(cuda, case):
    """0/1/2 errors (an odd count takes the scalar loads), and errors on
    subset 0's moduli mixed with clean elements in every warp."""
    allm, psi = _rrns_setup(5)
    tables = rrns.get_tables(allm, 3, psi)
    kind, size = case.split("-")
    if kind == "corrupt":
        res = _corrupt(allm, psi, seed=9, size=int(size))
    else:
        res, _ = _subset0_faults(allm, psi, seed=9, size=int(size))
    res = _t(res).to(cuda)
    dec, votes = ops.rrns_decode(res, tables)
    want_dec, want_votes = ref.rrns_decode_ref(res, tables)
    assert torch.equal(dec, want_dec)
    assert torch.equal(votes, want_votes)
    with pytest.raises(ValueError, match="f32"):
        allm6, psi6 = _rrns_setup(6)
        ops.rrns_decode(_t(_corrupt(allm6, psi6, 1)).to(cuda),
                        rrns.get_tables(allm6, 3, psi6))
