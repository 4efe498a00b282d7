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

An expert stack (``x (E, C, K)``, ``w (E, K, N)``: the MoE layer, where
the JAX package vmaps these backends over the experts) folds E into the
residue kernels' slot axis, (n_mod, E x G) slots. As under that vmap,
whose key is not batched, every stochastic stage draws ONCE per call at
one expert's shape (``_dims_tag`` of one expert's operands, the detector
noise ``(n_mod, G, M, N)``, the programming drift of a per-call weight,
the bursts) and every expert reuses the draw; the fused-readout kernel
reads slot e x G + j's noise at group j. On the card a stack's residues
run in the blocks of :func:`repro_torch.core.backends.mirage_rns
.card_blocks` (whole experts, or one expert's groups where its residues
alone pass the budget: mixtral's prefill gate/up holds 94 GB in one
piece), each block through the readout, decode and scale-accumulate,
each reading its slice of the one draw; a 2-D GEMM is one launch. The
health counters are sums over the experts, as the JAX package's lift of
the vmapped records gives.

Randomness comes from ``draws`` (:class:`repro_torch.analog.channel.Draws`):
explicit, the engine's :func:`repro_torch.core.gemm.noise_scope`, or, at
keyless call sites, a generator seeded from ``policy.noise_seed`` and the
operand dims (a static error pattern per GEMM site, as the JAX package's
``_channel_key``).

Under an open :func:`repro_torch.analog.channel.fault_scope` (the serving
engine's chaos injection) the stages read the fault controls: the
detector noise is drawn even on a clean config, at the sigmas times
``sigma_scale``; the bursts are drawn at the config's rate plus the
controls' ``burst_rate``, at the wider of the two widths; and on the card
the GEMM takes the residue kernel followed by the plain readout chain
(which clamps the stuck channels), never the fused readout, as the JAX
package's ``use_pallas`` route does under a scope.
"""

from __future__ import annotations

import torch

from repro_torch.analog import channel, rrns
from repro_torch.core import rns, stationary
from repro_torch.core.backends import grouped, mirage_rns
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
    stack = grouped.is_stack(w)
    if isinstance(w, stationary.StationaryResidues):
        if not allow_stationary:
            raise ValueError(
                "the reference backend keeps the pre-fusion per-call "
                "pipeline and does not accept stationary residues")
        w.check_matches(policy, moduli, x.shape[-1])
        qx, sx, batch = grouped.prepare_activations(x, policy, stack)
        wr, sw = w.residues, w.scale
    else:
        qx, sx, qw, sw, batch = grouped.prepare_operands(x, w, policy)
        wr = rns.to_rns(qw, moduli)            # (n_mod, [E,] G, g, N) int32
        wr = channel.apply_program_channel(wr, moduli, cfg, draws,
                                           stack=stack)
    xr = rns.to_rns(qx, moduli)                # (n_mod, [E,] G, M, g) int32
    xr = channel.converter_quantize(xr, moduli, cfg.dac_bits)
    return xr, wr, sx, sw, batch


def _readout_on_card(xr, wr, moduli, cfg, noise):
    """One block's residue GEMM through the fused-readout kernel: ``xr
    (n_mod, S, M, g)``, ``wr (n_mod, S, g, N)`` and the block's detector
    noise ``(n_mod, P, M, N)``, scaled, which slot s reads at s mod P (P
    the block's groups, one draw for all of its experts)."""
    from repro_torch.kernels import ops as kops
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
    stack = grouped.is_stack(w)
    # runtime fault controls make the otherwise static stages data
    # dependent: the noise and burst stages run even where the config
    # alone would skip them, and they need draws
    ctl = channel.fault_controls()
    if cfg.stochastic or ctl is not None:
        k_shape = (w.orig_k, w.n_out) \
            if isinstance(w, stationary.StationaryResidues) \
            else tuple(w.shape[-2:])
        x_shape = tuple(x.shape[1:]) if stack else tuple(x.shape)
        draws = _channel_draws(policy, draws, (x_shape, k_shape), x.device)
        if not stack:
            # one rank's block of a meshed GEMM draws the whole GEMM's
            # numbers (an expert stack's draw is one expert's, whole)
            draws = channel.block_draws(draws)
    if reference and stack:
        # the oracle runs one expert at a time, every expert on one draw
        shared = channel.SharedDraws(draws) if draws is not None else None
        return torch.stack([_analog_forward(x[e], w[e], policy, shared,
                                            correct, reference=True)
                            for e in range(x.shape[0])])
    xr, wr, sx, sw, batch = _prepare(x, w, policy, moduli, cfg, draws,
                                     allow_stationary=not reference)
    xr, wr, sx, sw = mirage_rns.as_stack(xr, wr, sx, sw, stack)
    nm, E, G, M, _ = xr.shape
    N = wr.shape[-1]
    sig = cfg.detector_sigmas(moduli)
    noisy = any(s > 0 for s in sig) or ctl is not None
    # every draw once, at one expert's shape, in the stages' order
    unit = draws.normal("detector", (nm, G, M, N)) if noisy else None
    bursts, width = None, cfg.burst_width
    if ctl is not None:
        # the schedule's storm adds onto the config's rate; the width is
        # the wider of the two
        bursts = channel.draw_bursts((G, M, N), moduli,
                                     ctl["burst_rate"] + cfg.burst_rate,
                                     draws)
        width = torch.clamp_min(ctl["burst_width"], cfg.burst_width)
    elif cfg.burst_rate > 0:
        bursts = channel.draw_bursts((G, M, N), moduli, cfg.burst_rate,
                                     draws)
    on_card = x.is_cuda and not reference
    # crosstalk mixes NEIGHBOUR group outputs, out of one output element's
    # reach, a noiseless readout has nothing to fuse, and the fault
    # controls' stuck clamp runs after the noise, in the plain chain
    fused = on_card and noisy and not cfg.crosstalk and ctl is None
    eb, gb = E, G
    if on_card and stack:
        # a 2-D GEMM stays one launch, as it always ran (its largest, the
        # gate/up of a 512-token prefill, holds 2.8 GB of residues)
        eb, gb = mirage_rns.card_blocks(nm, E, G, M, N)
        if cfg.crosstalk and gb < G:
            eb, gb = 1, G              # the crosstalk needs every group
    if correct:
        tables = rrns.get_tables(moduli, n_required=len(policy.moduli),
                                 psi=policy.psi)
    sig_col = channel.scaled_sigmas(sig, ctl, 4, xr.device)

    def block(xb, wb, es, gs):
        shape = (nm, es.stop - es.start, gs.stop - gs.start, M, N)
        noise = unit[:, gs] * sig_col if noisy else None
        if fused:
            res = _readout_on_card(xb, wb, moduli, cfg, noise).reshape(shape)
        else:
            if on_card:
                from repro_torch.kernels import ops as kops
                res = kops.rns_group_matmul(xb, wb, moduli)
            else:
                res = grouped.residue_dots(xb, wb, moduli)
            res = channel.apply_readout_channel(
                res.reshape(shape), moduli, cfg, None, stack=True,
                noise=None if noise is None else noise[:, None])
        del noise
        if bursts is not None:
            res = channel.apply_bursts(res, moduli, width, bursts.block(gs),
                                       stack=True)
        if not correct:
            return rns.from_rns_special(res, policy.k).to(torch.float32)
        if reference:
            decoded, _ = rrns.rrns_decode_reference(res, tables)
        else:
            decoded, _ = rrns.rrns_decode(res, tables)
        return decoded.to(torch.float32)

    return mirage_rns.run_blocks(xr, wr, sx, sw, eb, gb,
                                 block).reshape(batch + (N,))


@register_fn("mirage_rns_noisy",
             description="RNS path through the full analog channel model "
                         "(DAC/drift/crosstalk/detector-SNR/ADC/burst), "
                         "uncorrected",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True,
             supports_batched_weights=True)
def _matmul_mirage_rns_noisy(x, w, policy, *, draws=None):
    return _analog_forward(x, w, policy, draws, correct=False)


@register_fn("mirage_rrns",
             description="redundant-RNS path: analog channel + fused "
                         "single-pass majority decode over CRT subset tables",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True,
             supports_batched_weights=True)
def _matmul_mirage_rrns(x, w, policy, *, draws=None):
    return _analog_forward(x, w, policy, draws, correct=True)


@register_fn("mirage_rrns_ref",
             description="pre-fusion RRNS pipeline (per-call weight encode, "
                         "subset-loop decode) — parity oracle",
             supports_noise=True,
             supports_batched_weights=True,
             reference=True)
def _matmul_mirage_rrns_ref(x, w, policy, *, draws=None):
    return _analog_forward(x, w, policy, draws, correct=True, reference=True)
