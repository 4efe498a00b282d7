"""Residue Number System arithmetic (port of ``repro.core.rns``).

Signed integers ``X`` in ``[-psi, psi]`` (``psi = (M-1)//2``, ``M = prod m_i``)
are represented by non-negative residues ``x_i = X mod m_i``. The RNS is
closed under + and *, so GEMMs run per modulus at ``ceil(log2 m_i)`` bits.

Residues are int32. ``torch.remainder`` takes the place of ``jnp.mod``: both
give the sign of the divisor, so negative mantissas land in ``[0, m)``
(``torch.fmod`` would keep the dividend's sign). The shift/add conversions
for the special set ``{2^k - 1, 2^k, 2^k + 1}`` run on int32 and are exact
for ``k <= 10``; :func:`from_rns_generic_np` is the python-int CRT oracle,
copied from the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# Forward conversion: BNS -> RNS
# --------------------------------------------------------------------------

def to_rns(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Residues of (possibly negative) integers, stacked on a new leading axis.

    x: integer-valued tensor (int32 or exact f32). Returns int32 of shape
    ``(n_moduli,) + x.shape`` with entries in ``[0, m_i)``.
    """
    xi = torch.round(x).to(torch.int32) if x.is_floating_point() \
        else x.to(torch.int32)
    out = torch.empty((len(moduli),) + tuple(xi.shape), dtype=torch.int32,
                      device=xi.device)
    for i, m in enumerate(moduli):
        torch.remainder(xi, m, out=out[i])
    return out


def to_rns_special(x: torch.Tensor, k: int) -> torch.Tensor:
    """Forward conversion for {2^k-1, 2^k, 2^k+1} using shifts/adds only.

      x mod 2^k     : low k bits
      x mod 2^k - 1 : sum of k-bit digits, folded
      x mod 2^k + 1 : alternating sum of k-bit digits, folded
    Input magnitude must satisfy |x| < M = 2^k (2^{2k} - 1).
    """
    m1, m2, m3 = 2**k - 1, 2**k, 2**k + 1
    M = m1 * m2 * m3
    xi = torch.round(x).to(torch.int32) if x.is_floating_point() \
        else x.to(torch.int32)
    xi = torch.remainder(xi, M)  # lift to [0, M)
    mask = m2 - 1
    d0 = xi & mask
    d1 = (xi >> k) & mask
    d2 = (xi >> (2 * k)) & mask
    d3 = xi >> (3 * k)  # nonzero only while folding
    # mod 2^k - 1: digit sum (2^k == 1 mod m1); two folds suffice
    s = d0 + d1 + d2 + d3
    s = (s & mask) + (s >> k)
    s = (s & mask) + (s >> k)
    r1 = torch.where(s == m1, torch.zeros_like(s), s)
    # mod 2^k + 1: alternating digit sum (2^k == -1 mod m3)
    r3 = torch.remainder(d0 - d1 + d2 - d3, m3)
    return torch.stack([r1, d0, r3], dim=0).to(torch.int32)


# --------------------------------------------------------------------------
# Reverse conversion: RNS -> BNS
# --------------------------------------------------------------------------

def from_rns_special(res: torch.Tensor, k: int,
                     signed: bool = True) -> torch.Tensor:
    """Adder-based CRT for {2^k-1, 2^k, 2^k+1} (int32-safe for k <= 10).

    With X = q * 2^k + r2: q == r1 - r2 (mod 2^k - 1) and q == r2 - r3
    (mod 2^k + 1); CRT over the co-prime pair, both inverses 2^(k-1), gives
    q = | (a (2^k+1) + b (2^k-1)) * 2^(k-1) |_{2^{2k} - 1}.
    """
    m1, m2, m3 = 2**k - 1, 2**k, 2**k + 1
    M = m1 * m2 * m3
    Mq = m1 * m3
    r1, r2, r3 = (res[i].to(torch.int32) for i in range(3))
    a = torch.remainder(r1 - r2, m1)
    b = torch.remainder(r2 - r3, m3)
    q = torch.remainder((a * m3 + b * m1) * (2 ** (k - 1)), Mq)
    X = q * m2 + r2
    if signed:
        psi = (M - 1) // 2
        X = torch.where(X > psi, X - M, X)
    return X.to(torch.int32)


def crt_constants(moduli: Sequence[int]) -> Tuple[int, Tuple[int, ...]]:
    """Generic CRT constants: M and c_i = (M_i * T_i) mod M (python ints)."""
    M = math.prod(moduli)
    consts = []
    for m in moduli:
        Mi = M // m
        consts.append((Mi * pow(Mi, -1, m)) % M)
    return M, tuple(consts)


def from_rns_generic_np(res: np.ndarray, moduli: Sequence[int],
                        signed: bool = True) -> np.ndarray:
    """Generic CRT oracle on the host with python-int precision (any moduli)."""
    M, consts = crt_constants(moduli)
    acc = np.zeros(res.shape[1:], dtype=object)
    for i, c in enumerate(consts):
        acc = (acc + res[i].astype(object) * c) % M
    if signed:
        psi = (M - 1) // 2
        acc = np.where(acc > psi, acc - M, acc)
    return acc.astype(np.int64)


# --------------------------------------------------------------------------
# Modular arithmetic primitives
# --------------------------------------------------------------------------

def mod_matmul(xr: torch.Tensor, wr: torch.Tensor, m: int) -> torch.Tensor:
    """(xr @ wr) mod m for non-negative residues, as f32 residues.

    Exact integer partial dots in f32, reduced mod m per partial: a K-wide
    dot is bounded by ``K * (m-1)^2``, so the contraction is chunked to keep
    every partial below 2^24 (f32's exact-integer window)."""
    xf = xr.to(torch.float32)
    wf = wr.to(torch.float32)
    K = xf.shape[-1]
    cap = max(1, ((1 << 24) - 1) // max(1, (m - 1) ** 2))
    if K <= cap:
        return torch.remainder(torch.matmul(xf, wf), float(m))
    acc = None
    for k0 in range(0, K, cap):
        part = torch.remainder(torch.matmul(xf[..., k0:k0 + cap],
                                            wf[..., k0:k0 + cap, :]),
                               float(m))
        acc = part if acc is None else acc + part
    return torch.remainder(acc, float(m))


def rns_matmul(x_res: torch.Tensor, w_res: torch.Tensor,
               moduli: Sequence[int]) -> torch.Tensor:
    """Per-modulus residue matmuls: (n, M, K) x (n, K, N) -> (n, M, N)."""
    return torch.stack([mod_matmul(x_res[i], w_res[i], m)
                        for i, m in enumerate(moduli)], dim=0)


def rns_dot_reconstruct(x: torch.Tensor, w: torch.Tensor,
                        k: int) -> torch.Tensor:
    """End-to-end integer matmul via RNS: quantized ints in, exact ints out.

    x: (..., K) integer-valued, w: (K, N) integer-valued. The result is exact
    as long as |x @ w| <= psi (Eq. 10, the caller's responsibility)."""
    moduli = (2**k - 1, 2**k, 2**k + 1)
    out_res = rns_matmul(to_rns_special(x, k), to_rns_special(w, k),
                         moduli).to(torch.int32)
    return from_rns_special(out_res, k, signed=True)
