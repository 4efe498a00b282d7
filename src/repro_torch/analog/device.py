"""Mirage device constants (paper Section IV-B) + receiver noise physics.

A copy of ``repro.analog.device`` (which imports no JAX), kept so the port
imports nothing of the JAX package; the port's analog channel
(``repro_torch.analog.channel``) derives its detector noise sigmas from the
same numbers. Change both copies together.

The receiver model turns an optical power at the detector into an SNR:
photocurrent ``I = R * P`` (responsivity R), shot-noise variance
``2 q I B`` and thermal (Johnson) variance ``4 k T B / R_load`` over the
detection bandwidth B. The paper's requirement "SNR > m" (§IV-B1) is an
*amplitude* SNR: the full-scale signal spans m phase levels, so a detector
at exactly the required SNR resolves one level.
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# Device constants (Section IV-B) — imported by benchmarks/hw_model.py
# ---------------------------------------------------------------------------

PHOTONIC_CLOCK_HZ = 10e9          # 10 GHz MVM rate
DIGITAL_CLOCK_HZ = 1e9            # 1 GHz digital, x10 interleaved
PS_PROGRAM_NS = 5.0               # phase-shifter settle per tile [3]
MVM_NS = 0.1                      # one MVM per 0.1 ns

PS_LOSS_DB = 0.04                 # 25um phase shifter loss
MRR_LOSS_DB = 0.2                 # MRR insertion+propagation when coupled
BEND_LOSS_DB = 0.01               # 180-degree bend
COUPLER_LOSS_DB = 0.2             # laser-to-chip coupler
LASER_EFF = 0.20                  # wall-plug efficiency
DETECTOR_A_PER_W = 1.1            # photodetector responsivity
TIA_J_PER_BIT = 57e-15
MRR_TUNE_W = 0.3e-12              # electro-optic MRR switching power

DAC6_W, DAC6_GSPS, DAC6_MM2 = 136e-3, 20e9, 0.072   # [27]
ADC6_W, ADC6_GSPS, ADC6_MM2 = 23e-3, 24e9, 0.03     # [56]
RNS_CONV_J = 0.48e-12             # per RNS-BNS conversion [21]
RNS_CONV_MM2 = 1545.8e-6          # mm^2
SRAM_BYTES = 3 * 8 * 2**20        # three 8MB arrays
SRAM_PJ_PER_BYTE = 0.6            # 40nm 32kB-bank read energy estimate
SRAM_MM2_PER_MB = 0.45            # 40nm SRAM compiler estimate

# device geometry for area
PS_LEN_UM = 25.0
MRR_RADIUS_UM = 10.0
WG_PITCH_UM = 5.0

P_RX_FLOOR_W = 1e-9   # ~1 nW: shot-noise-limited receiver floor at 10 GHz

# receiver front-end (shot/thermal noise model)
ELECTRON_CHARGE_C = 1.602176634e-19
BOLTZMANN_J_PER_K = 1.380649e-23
RECEIVER_TEMP_K = 300.0
TIA_LOAD_OHM = 50.0


def receiver_snr_db(p_rx_w: float,
                    bandwidth_hz: float = PHOTONIC_CLOCK_HZ,
                    responsivity: float = DETECTOR_A_PER_W) -> float:
    """Amplitude SNR (dB) of the shot/thermal-limited receiver at power P.

    SNR_amp = I / sqrt(2 q I B + 4 k T B / R_load); returned as 20*log10.
    """
    if p_rx_w <= 0:
        return -math.inf
    i_ph = responsivity * p_rx_w
    shot = 2.0 * ELECTRON_CHARGE_C * i_ph * bandwidth_hz
    thermal = (4.0 * BOLTZMANN_J_PER_K * RECEIVER_TEMP_K * bandwidth_hz
               / TIA_LOAD_OHM)
    return 20.0 * math.log10(i_ph / math.sqrt(shot + thermal))


def snr_requirement_db(m: int) -> float:
    """Paper §IV-B1: to distinguish m phase levels the core needs SNR > m."""
    return 20.0 * math.log10(m)


def receiver_power_for_snr_w(snr_db: float,
                             bandwidth_hz: float = PHOTONIC_CLOCK_HZ,
                             responsivity: float = DETECTOR_A_PER_W) -> float:
    """Inverse of :func:`receiver_snr_db` (bisection on the monotone model)."""
    lo, hi = 1e-15, 1e6
    for _ in range(260):
        mid = math.sqrt(lo * hi)
        if receiver_snr_db(mid, bandwidth_hz, responsivity) < snr_db:
            lo = mid
        else:
            hi = mid
    p = math.sqrt(lo * hi)
    achieved = receiver_snr_db(p, bandwidth_hz, responsivity)
    if achieved < snr_db - 0.5:
        raise ValueError(
            f"requested SNR {snr_db:.1f} dB unreachable within the "
            f"bisection bracket (achieved {achieved:.1f} dB at {p:.3g} W)")
    return p
