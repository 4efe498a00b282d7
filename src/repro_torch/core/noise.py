"""Analog phase noise + the RRNS host oracle (port of ``repro.core.noise``,
paper §VII)."""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import rns


def inject_phase_noise(residues: torch.Tensor, moduli: Sequence[int],
                       sigma: float, draws) -> torch.Tensor:
    """Additive Gaussian phase noise on the residue readout, re-quantized
    to the nearest level and wrapped mod m: the flat special case of
    :func:`repro_torch.analog.channel.phase_noise` (its ``"detector"``
    draw)."""
    from repro_torch.analog import channel
    return channel.phase_noise(residues, moduli, (sigma,) * len(moduli),
                               draws)


def rrns_decode_np(residues: np.ndarray, moduli: Sequence[int],
                   n_required: int, psi: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Majority-vote RRNS decoding on the host (python-int CRT), copied from
    the JAX package: every size-``n_required`` subset reconstructs X; the
    legal value (|X| <= psi) with the most votes wins, ties to the first.

    Returns (decoded, corrected_mask)."""
    n_total = len(moduli)
    flat = residues.reshape(n_total, -1)
    out = np.zeros(flat.shape[1], dtype=np.int64)
    corrected = np.zeros(flat.shape[1], dtype=bool)
    subsets = list(itertools.combinations(range(n_total), n_required))
    for j in range(flat.shape[1]):
        votes = {}
        for sub in subsets:
            sub_moduli = [moduli[i] for i in sub]
            sub_res = flat[list(sub), j][:, None]
            val = int(rns.from_rns_generic_np(sub_res, sub_moduli)[0])
            if abs(val) <= psi:
                votes[val] = votes.get(val, 0) + 1
        if not votes:
            out[j] = 0
            corrected[j] = True
            continue
        best = max(votes.items(), key=lambda kv: kv[1])
        out[j] = best[0]
        corrected[j] = best[1] < len(subsets)
    return (out.reshape(residues.shape[1:]),
            corrected.reshape(residues.shape[1:]))


def snr_requirement_db(m: int) -> float:
    """Paper §IV-B1: to distinguish m phase levels the core needs SNR > m."""
    from repro_torch.analog import device
    return device.snr_requirement_db(m)
