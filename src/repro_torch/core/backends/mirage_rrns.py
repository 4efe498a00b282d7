"""mirage_rns_noisy / mirage_rrns: the RNS path through the analog channel
(port of ``repro.core.backends.mirage_rrns``).

  mirage_rns_noisy  base moduli; corrupted residues go straight into CRT
                    (the uncorrected baseline of §VII).
  mirage_rrns       base + redundant moduli; the readout is majority-decoded
                    by the fused RRNS decode, correcting any single residue
                    error with the default 2 redundant moduli.
  mirage_rrns_ref   the pre-fusion pipeline (per-call weight encode +
                    subset-loop decode), a parity oracle.

Routes, by the operand's device. On the card (the JAX ``use_pallas``
route): crosstalk or a noiseless readout takes the residue kernel followed
by the plain readout chain; otherwise the detector noise is pre-sampled as
``normal((n_mod, G, M, N)) * sigma_m`` and the fused-readout kernel applies
it and the ADC in its epilogue; the RRNS decode is the decode kernel. On
the CPU: plain residue dots, the plain readout chain, the plain decode.
Both draw the detector noise as the same ``"detector"`` draw, so the same
draws give the same residues.

Randomness comes from ``draws`` (:class:`repro_torch.analog.channel.Draws`):
explicit, the engine's :func:`repro_torch.core.gemm.noise_scope`, or, at
keyless call sites, a generator seeded from ``policy.noise_seed`` and the
operand dims (a static error pattern per GEMM site, as the JAX package's
``_channel_key``).
"""

from __future__ import annotations

import torch

from repro_torch.analog import channel, rrns
from repro_torch.core import rns, stationary
from repro_torch.core.backends import grouped
from repro_torch.core.backends.base import register_fn
from repro_torch.obs import health as obs_health


def _dims_tag(shapes) -> int:
    """Deterministic fold of operand dims into a 31-bit tag (the JAX
    package's, so one ``noise_seed`` means the same sites in both)."""
    t = 0
    for shape in shapes:
        for d in shape:
            t = (t * 1000003 + int(d) + 0x9E3779B1) % 0x7FFFFFFF
    return t


def _channel_draws(policy, draws, shapes, dev):
    if draws is not None:
        return draws
    if policy.noise_seed is not None:
        return channel.GeneratorDraws(channel.seeded_generator(
            dev, "gemm", policy.noise_seed, _dims_tag(shapes)))
    raise ValueError(
        "the analog channel has stochastic stages (snr_db / noise_sigma / "
        "phase_drift_sigma / burst_rate) but no randomness: pass draws= to "
        "mirage_matmul_nograd, open gemm.noise_scope, or set "
        "policy.noise_seed")


def _prepare(x, w, policy, moduli, cfg, draws, allow_stationary):
    """Residue-encode both operands; a stationary weight skips the whole
    weight-side pipeline (programmed at admission)."""
    if isinstance(w, stationary.StationaryResidues):
        if not allow_stationary:
            raise ValueError(
                "the reference backend keeps the pre-fusion per-call "
                "pipeline and does not accept stationary residues")
        w.check_matches(policy, moduli, x.shape[-1])
        qx, sx, batch = grouped.prepare_activations(x, policy)
        wr, sw = w.residues, w.scale
    else:
        qx, sx, qw, sw, batch = grouped.prepare_operands(x, w, policy)
        wr = rns.to_rns(qw, moduli)                # (n_mod, G, g, N) int32
        wr = channel.apply_program_channel(wr, moduli, cfg, draws)
    xr = rns.to_rns(qx, moduli)                    # (n_mod, G, M, g) int32
    xr = channel.converter_quantize(xr, moduli, cfg.dac_bits)
    return xr, wr, sx, sw, batch


def _readout_on_card(xr, wr, moduli, cfg, draws):
    from repro_torch.kernels import ops as kops
    sig = cfg.detector_sigmas(moduli)
    if cfg.crosstalk or not any(s > 0 for s in sig):
        # crosstalk mixes NEIGHBOUR group outputs, out of one output
        # element's reach, and a noiseless readout has nothing to fuse
        res = kops.rns_group_matmul(xr, wr, moduli)
        return channel.apply_readout_channel(res, moduli, cfg, draws)
    n_mod, G, M, _ = xr.shape
    N = wr.shape[-1]
    sig_col = channel.device_constant(tuple(sig), torch.float32,
                                      xr.device).reshape(-1, 1, 1, 1)
    noise = draws.normal("detector", (n_mod, G, M, N)) * sig_col
    if not obs_health.active():
        return kops.rns_group_matmul_channel(xr, wr, moduli, noise,
                                             adc_bits=cfg.adc_bits)
    # the noise is applied inside the kernel epilogue, which counts the
    # residues it moved (wrapped against clean, as the JAX package's
    # default route compares them); a count from the draw, round(n) % m !=
    # 0, would differ where the f32 sum res + n is exactly a half-integer
    res, flips = kops.rns_group_matmul_channel(
        xr, wr, moduli, noise, adc_bits=cfg.adc_bits, count_flips=True)
    obs_health.record("detector_flips", flips)
    return res


def _analog_forward(x, w, policy, draws, correct: bool,
                    reference: bool = False):
    cfg = channel.AnalogChannelConfig.from_policy(policy)
    moduli = rrns.rrns_moduli(policy) if correct else tuple(policy.moduli)
    if cfg.stochastic:
        k_shape = (w.orig_k, w.n_out) \
            if isinstance(w, stationary.StationaryResidues) \
            else tuple(w.shape)
        draws = _channel_draws(policy, draws, (tuple(x.shape), k_shape),
                               x.device)
    xr, wr, sx, sw, batch = _prepare(x, w, policy, moduli, cfg, draws,
                                     allow_stationary=not reference)
    on_card = x.is_cuda and not reference
    if on_card:
        res = _readout_on_card(xr, wr, moduli, cfg, draws)
    else:
        res = grouped.residue_dots(xr, wr, moduli)
        res = channel.apply_readout_channel(res, moduli, cfg, draws)
    if cfg.burst_rate > 0:
        res = channel.burst_errors(res, moduli, cfg.burst_rate,
                                   cfg.burst_width, draws)
    if correct:
        tables = rrns.get_tables(moduli, n_required=len(policy.moduli),
                                 psi=policy.psi)
        if reference:
            decoded, _ = rrns.rrns_decode_reference(res, tables)
        else:
            decoded, _ = rrns.rrns_decode(res, tables)
        p = decoded.to(torch.float32)
    else:
        p = rns.from_rns_special(res, policy.k).to(torch.float32)
    return grouped.scale_accumulate(p, sx, sw, batch)


@register_fn("mirage_rns_noisy",
             description="RNS path through the full analog channel model "
                         "(DAC/drift/crosstalk/detector-SNR/ADC/burst), "
                         "uncorrected",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True)
def _matmul_mirage_rns_noisy(x, w, policy, *, draws=None):
    return _analog_forward(x, w, policy, draws, correct=False)


@register_fn("mirage_rrns",
             description="redundant-RNS path: analog channel + fused "
                         "single-pass majority decode over CRT subset tables",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True)
def _matmul_mirage_rrns(x, w, policy, *, draws=None):
    return _analog_forward(x, w, policy, draws, correct=True)


@register_fn("mirage_rrns_ref",
             description="pre-fusion RRNS pipeline (per-call weight encode, "
                         "subset-loop decode) — parity oracle",
             supports_noise=True,
             reference=True)
def _matmul_mirage_rrns_ref(x, w, policy, *, draws=None):
    return _analog_forward(x, w, policy, draws, correct=True, reference=True)
