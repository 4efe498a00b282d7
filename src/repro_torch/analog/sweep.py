"""Accuracy-vs-SNR sweep campaigns (port of ``repro.analog.sweep``; Fig.
10-style, paper §VII).

Given detector SNR points, measure (a) the GEMM's relative error and (b)
a small LM's training loss for the uncorrected analog path
(``mirage_rns_noisy``) and the RRNS-corrected one (``mirage_rrns``),
against the noiseless ``mirage_rns`` and FP32 references. Every function
returns row dicts, as the JAX package's do.

With amplitude SNR ``s`` the per-modulus noise sigma is ``m / 10^(s/20)``
phase levels, so residue flips become likely below ~45 dB for the paper's
k=5 moduli; RRNS with two redundant moduli repairs every single-residue
flip and moves the usable SNR floor down by several dB.

Randomness: the GEMM sweep's channel noise comes from a :class:`Draws`
per row (:class:`repro_torch.analog.channel.GeneratorDraws` seeded from
``seed``, the same for every row as the JAX package's key is), or from
the caller's ``draws``, which is how a test replays the JAX package's
draws. The training sweep's noise reaches the step through
``policy.noise_seed`` (a static error pattern per GEMM site). Everything
runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analog.channel import Draws, GeneratorDraws
from repro_torch.core.precision import get_policy
from repro_torch.device import resolve_device

# the residue-flip transition for the k=5 moduli lives between ~38 and
# ~50 dB; sample that shoulder densely
DEFAULT_SNR_DBS = (38.0, 40.0, 42.0, 44.0, 46.0, 48.0, 50.0, 55.0)
NOISY_MODES = ("mirage_rns_noisy", "mirage_rrns")


def gemm_error_sweep(snr_dbs: Sequence[float] = DEFAULT_SNR_DBS,
                     modes: Sequence[str] = NOISY_MODES,
                     shape=(32, 256, 32), seed: int = 0,
                     policy_overrides: Optional[Dict] = None,
                     draws: Optional[Callable[[float, str], Draws]] = None,
                     device=None) -> List[Dict]:
    """Relative GEMM error vs SNR for each analog mode.

    The reference is the NOISELESS ``mirage_rns`` output, so the metric
    isolates channel corruption from BFP quantization error: the relative
    Frobenius norm of the error, and the fraction of output elements it
    corrupts (which shows the correction even where a rare multi-residue
    error dominates the norm). ``draws(snr_db, mode)`` gives a row's
    random numbers."""
    from repro_torch.core import gemm

    dev = resolve_device(device)
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    overrides = dict(policy_overrides or {})
    ref = gemm.mirage_matmul_nograd(
        x, w, get_policy("mirage_rns", **overrides)).cpu().numpy()
    ref_norm = float(np.linalg.norm(ref)) or 1.0
    tol = 1e-6 * float(np.abs(ref).max() or 1.0)
    rows: List[Dict] = []
    for snr in snr_dbs:
        for mode in modes:
            policy = get_policy(mode, snr_db=float(snr), **overrides)
            d = draws(snr, mode) if draws is not None else GeneratorDraws(
                torch.Generator(device=dev).manual_seed(seed))
            out = gemm.mirage_matmul_nograd(x, w, policy,
                                            draws=d).cpu().numpy()
            err = out - ref
            rows.append({
                "section": "noise_gemm",
                "mode": mode,
                "snr_db": float(snr),
                "rel_fro_err": float(np.linalg.norm(err) / ref_norm),
                "corrupt_frac": float(np.mean(np.abs(err) > tol)),
                "shape": list(shape),
            })
    return rows


def train_loss_sweep(snr_dbs: Sequence[float] = (40.0, 50.0),
                     modes: Sequence[str] = NOISY_MODES,
                     steps: int = 12, seed: int = 0, device=None,
                     init: Optional[Callable] = None) -> List[Dict]:
    """Final small-LM train loss vs SNR, with the noiseless ``mirage_rns``
    and ``fp32`` runs as anchors. ``init(model)`` may replace each model's
    seeded weights (a test loads the JAX package's)."""
    rows: List[Dict] = []
    anchors = {"fp32": get_policy("fp32"),
               "mirage_rns": get_policy("mirage_rns")}
    for name, policy in anchors.items():
        rows.append({"section": "noise_train", "mode": name,
                     "snr_db": None,
                     "loss": _train_small_lm(policy, steps, seed, device,
                                             init)})
    for snr in snr_dbs:
        for mode in modes:
            policy = get_policy(mode, snr_db=float(snr), noise_seed=seed)
            rows.append({"section": "noise_train", "mode": mode,
                         "snr_db": float(snr),
                         "loss": _train_small_lm(policy, steps, seed, device,
                                                 init)})
    return rows


def _train_small_lm(policy, steps: int, seed: int, device=None,
                    init: Optional[Callable] = None) -> float:
    """The reduced LM on synthetic bigram data under AdamW (the JAX
    package's recipe): the loss after ``steps`` steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions
    from repro_torch.runtime.trainer import init_train_state, make_train_step

    dev = resolve_device(device)
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, policy, LMCallOptions(q_chunk=16, kv_chunk=16),
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(seed))
    if init is not None:
        init(model)
    tc = TrainConfig(policy=policy, optimizer="adamw", lr=1e-3)
    state = init_train_state(model, tc)
    step = make_train_step(model, tc)
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=32, batch_size=4, seed=seed))
    metrics = {}
    for _ in range(steps):
        state, metrics = step(state, next(data))
    return float(metrics["loss"])
