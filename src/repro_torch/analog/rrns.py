"""Redundant-RNS (RRNS) encode + single-pass majority decode (port of
``repro.analog.rrns``, paper §VII).

One residue phase error explodes through CRT, so ``r`` redundant moduli
are added and the value is reconstructed from every size-``n`` subset of
the ``n + r`` moduli; the legal value (``|X| <= psi``) most subsets agree
on wins. With ``r = 2`` any single residue error is corrected.

The decode is the JAX package's fused one: a subset ``t`` reconstructs the
same value as ``s`` iff every modulus of ``t`` is consistent with ``X_s``,
so the vote count of ``X_s`` is ``C(n_required + extra_s, n_required)``,
with ``extra_s`` the complement moduli consistent with ``X_s``. One
reconstruction and ``n_total - n_required`` congruence checks per subset,
and a running first-max winner. When every bound fits f32's exact-integer
window (``tables.f32_exact``; the paper point does) it runs in f32, else in
int32 per-term modular arithmetic.

:func:`rrns_decode` routes through :func:`repro_torch.kernels.ops.rrns_decode`:
a CUDA tensor launches the hand-written kernel (f32 tables only), a CPU
tensor takes :func:`decode_votes`. ``repro_torch.core.noise.rrns_decode_np``
is the python-int oracle; :func:`rrns_decode_reference` keeps the
pre-fusion subset-loop decode as a second oracle.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import rns
from repro_torch.obs import health as obs_health


def default_redundant_moduli(k: int, r: int = 2) -> Tuple[int, ...]:
    """First ``r`` primes above ``2^k + 1``: co-prime to the special set and
    to each other, and >= every base modulus."""
    out = []
    cand = 2 ** k + 2
    while len(out) < r:
        if all(cand % p for p in range(2, int(math.isqrt(cand)) + 1)):
            out.append(cand)
        cand += 1
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RRNSTables:
    """Static CRT subset tables for one (moduli, n_required, psi) decode
    (the JAX package's fields).

    weights[s, i] is the CRT weight ``(M_i * T_i) mod M_s`` of modulus i in
    subset s (0 for non-members); ``binom[e] = C(n_required + e,
    n_required)``; ``vote_threshold`` is the least winner vote count inside
    the correction radius ``floor(r/2)``."""

    moduli: Tuple[int, ...]
    n_required: int
    psi: int
    subsets: Tuple[Tuple[int, ...], ...]
    weights: np.ndarray       # (S, n_total) int32
    subset_M: np.ndarray      # (S,) int32
    subset_psi: np.ndarray    # (S,) int32
    members: np.ndarray       # (S, n_required) int32
    comp: np.ndarray          # (S, n_total - n_required) int32
    binom: Tuple[int, ...]
    f32_exact: bool
    vote_threshold: int

    @property
    def n_subsets(self) -> int:
        return len(self.subsets)


_F32_WINDOW = 1 << 24


def build_tables(moduli: Sequence[int], n_required: int,
                 psi: int) -> RRNSTables:
    """Precompute CRT weights for all C(n_total, n_required) subsets."""
    moduli = tuple(int(m) for m in moduli)
    n_total = len(moduli)
    if not 0 < n_required <= n_total:
        raise ValueError(f"n_required={n_required} out of range for "
                         f"{n_total} moduli")
    for a, b in itertools.combinations(moduli, 2):
        if math.gcd(a, b) != 1:
            raise ValueError(f"moduli must be pairwise co-prime; "
                             f"gcd({a}, {b}) != 1")
    subsets = tuple(itertools.combinations(range(n_total), n_required))
    m_max = max(moduli)
    weights = np.zeros((len(subsets), n_total), np.int64)
    subset_M = np.zeros(len(subsets), np.int64)
    f32_exact = True
    for s, sub in enumerate(subsets):
        sub_moduli = [moduli[i] for i in sub]
        M_s, consts = rns.crt_constants(sub_moduli)
        subset_M[s] = M_s
        for i, c in zip(sub, consts):
            weights[s, i] = c
        if m_max * (M_s - 1) >= 2 ** 31:
            raise ValueError(
                f"subset {sub_moduli}: modular-accumulation bound "
                f"{m_max * (M_s - 1)} leaves int32; use smaller k or fewer "
                f"moduli")
        if M_s < 2 * psi + 1:
            raise ValueError(
                f"subset {sub_moduli}: range M={M_s} cannot represent the "
                f"legal interval [-{psi}, {psi}] — redundant moduli must be "
                f">= every base modulus")
        if n_required * (m_max - 1) * (M_s - 1) + M_s >= _F32_WINDOW:
            f32_exact = False
    members = np.asarray(subsets, np.int64).reshape(len(subsets), n_required)
    comp = np.asarray(
        [[i for i in range(n_total) if i not in sub] for sub in subsets],
        np.int64).reshape(len(subsets), n_total - n_required)
    binom = tuple(math.comb(n_required + e, n_required)
                  for e in range(n_total - n_required + 1))
    r = n_total - n_required
    return RRNSTables(
        moduli=moduli, n_required=n_required, psi=int(psi), subsets=subsets,
        weights=weights.astype(np.int32),
        subset_M=subset_M.astype(np.int32),
        subset_psi=((subset_M - 1) // 2).astype(np.int32),
        members=members.astype(np.int32), comp=comp.astype(np.int32),
        binom=binom, f32_exact=bool(f32_exact),
        vote_threshold=int(math.comb(n_required + r - r // 2, n_required)))


@functools.lru_cache(maxsize=64)
def get_tables(moduli: Tuple[int, ...], n_required: int,
               psi: int) -> RRNSTables:
    """Cached :func:`build_tables` (backends ask per GEMM call)."""
    return build_tables(moduli, n_required, psi)


def rrns_moduli(policy) -> Tuple[int, ...]:
    """Base + redundant moduli of a policy's error-corrected mode (explicit
    ``policy.redundant_moduli``, else the default primes)."""
    extra = tuple(policy.redundant_moduli) or \
        default_redundant_moduli(policy.k)
    return tuple(policy.moduli) + extra


def rrns_encode(x: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Residues over the full (base + redundant) moduli set."""
    return rns.to_rns(x, moduli)


# --------------------------------------------------------------------------
# Fused single-pass decode
# --------------------------------------------------------------------------

def _fold_signed_f32(acc: torch.Tensor, M_s: int,
                     psi_s: int) -> torch.Tensor:
    """Signed representative of ``acc mod M_s`` in ``[psi_s + 1 - M_s,
    psi_s]``: one round-based fold, two selects for the half-up boundary
    and the reciprocal's possible off-by-one."""
    Mf, lo = float(M_s), float(psi_s + 1 - M_s)
    q = torch.floor(acc * (1.0 / Mf) + 0.5)
    X = acc - q * Mf
    X = torch.where(X > float(psi_s), X - Mf, X)
    return torch.where(X < lo, X + Mf, X)


def _is_multiple_f32(d: torch.Tensor, m: int) -> torch.Tensor:
    """Exact ``d == 0 (mod m)`` for integer-valued f32 ``|d| < 2^24``."""
    k = torch.round(d * (1.0 / float(m)))
    return d - k * float(m) == 0.0


def decode_votes(residues: torch.Tensor, tables: RRNSTables
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused decode in plain PyTorch: ``(decoded int32, votes f32)``.

    ``votes`` is the winner's vote count, -1 where no subset is legal (the
    value is then 0). The plain version of ``csrc/rrns_decode.cu``."""
    S = tables.n_subsets
    n_comp = tables.comp.shape[1]
    moduli = tables.moduli
    fast = tables.f32_exact
    res = residues.to(torch.float32 if fast else torch.int32)
    shape = res.shape[1:]
    best_votes = torch.full(shape, -2.0, device=res.device)
    best_val = torch.zeros(shape, dtype=res.dtype, device=res.device)
    for s in range(S):
        M_s = int(tables.subset_M[s])
        psi_s = int(tables.subset_psi[s])
        if fast:
            acc = None
            for j in tables.members[s]:
                term = res[int(j)] * float(int(tables.weights[s, int(j)]))
                acc = term if acc is None else acc + term
            X = _fold_signed_f32(acc, M_s, psi_s)
        else:
            acc = torch.zeros(shape, dtype=torch.int32, device=res.device)
            for j in tables.members[s]:
                c = int(tables.weights[s, int(j)])
                acc = torch.remainder(acc + res[int(j)] * c, M_s)
            X = torch.where(acc > psi_s, acc - M_s, acc)
        extra = None
        for i in tables.comp[s]:
            m_i = moduli[int(i)]
            if fast:
                ok = _is_multiple_f32(X - res[int(i)], m_i)
            else:
                ok = torch.remainder(X - res[int(i)], m_i) == 0
            ok = ok.to(torch.float32)
            extra = ok if extra is None else extra + ok
        votes = torch.full(shape, float(tables.binom[0]), device=res.device)
        if extra is not None:
            for e in range(1, n_comp + 1):
                votes = torch.where(extra == float(e),
                                    float(tables.binom[e]), votes)
        votes = torch.where(torch.abs(X) <= tables.psi, votes, -1.0)
        # strict > keeps the FIRST max: subset order is the oracle's dict
        # insertion order, so ties resolve to the first-inserted value
        better = votes > best_votes
        best_votes = torch.where(better, votes, best_votes)
        best_val = torch.where(better, X, best_val)
    decoded = torch.where(best_votes >= 0.0, best_val,
                          torch.zeros((), dtype=best_val.dtype,
                                      device=res.device))
    return decoded.to(torch.int32), best_votes


def rrns_decode(residues: torch.Tensor, tables: RRNSTables
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused majority-vote RRNS decode.

    residues: (n_total, ...) int32 over ``tables.moduli``. Returns
    ``(decoded, corrected)``: int32 values (0 where no subset is legal) and
    a bool mask of positions where at least one subset disagreed — the
    semantics of ``rrns_decode_np``. Under an open health scope it records
    ``rrns_corrected`` (winner inside the correction radius, with dissent)
    and ``rrns_uncorrected`` (winner beyond it)."""
    from repro_torch.kernels import ops as kops

    S = tables.n_subsets
    decoded, votes = kops.rrns_decode(residues, tables)
    corrected = torch.where(votes >= 0.0, votes < float(S), True)
    if obs_health.active():
        n_trusted = torch.sum(votes >= float(tables.vote_threshold))
        n_full = torch.sum(votes >= float(S))
        obs_health.record("rrns_corrected", n_trusted - n_full)
        obs_health.record("rrns_uncorrected", votes.numel() - n_trusted)
    return decoded, corrected


def rrns_decode_reference(residues: torch.Tensor, tables: RRNSTables
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-fusion decode: subset loop + ``O(S^2)`` vote stack, kept as a
    parity oracle (and the ``mirage_rrns_ref`` decode)."""
    S = tables.n_subsets
    res = residues.to(torch.int32)
    Xs = []
    for s, sub in enumerate(tables.subsets):
        M_s = int(tables.subset_M[s])
        psi_s = int(tables.subset_psi[s])
        acc = torch.zeros(res.shape[1:], dtype=torch.int32, device=res.device)
        for i in sub:
            acc = torch.remainder(acc + res[i] * int(tables.weights[s, i]),
                                  M_s)
        Xs.append(torch.where(acc > psi_s, acc - M_s, acc))
    X = torch.stack(Xs, dim=0)
    legal = torch.abs(X) <= tables.psi
    votes = torch.stack([torch.sum((X == X[s][None]) & legal, dim=0)
                         for s in range(S)], dim=0)
    votes = torch.where(legal, votes, -1)
    # argmax ties resolve to the lowest subset index, as the oracle's dict
    best = _first_argmax(votes)
    decoded = torch.gather(X, 0, best[None])[0]
    max_votes = torch.gather(votes, 0, best[None])[0]
    any_legal = torch.any(legal, dim=0)
    decoded = torch.where(any_legal, decoded, 0)
    corrected = torch.where(any_legal, max_votes < S, True)
    if obs_health.active():
        trusted = max_votes >= tables.vote_threshold
        obs_health.record("rrns_corrected", torch.sum(trusted &
                                                      (max_votes < S)))
        obs_health.record("rrns_uncorrected", torch.sum(~trusted))
    return decoded.to(torch.int32), corrected


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along axis 0 (``jnp.argmax``'s ties)."""
    best = torch.zeros(v.shape[1:], dtype=torch.int64, device=v.device)
    best_v = v[0]
    for s in range(1, v.shape[0]):
        better = v[s] > best_v
        best = torch.where(better, s, best)
        best_v = torch.where(better, v[s], best_v)
    return best
