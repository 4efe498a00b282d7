"""Numerics showcase (the twin of ``examples/mirage_vs_fp32.py``): the
paper's central claims, observable in minutes.

  PYTHONPATH=src python -m repro_torch.examples.mirage_vs_fp32
  PYTHONPATH=src python -m repro_torch.examples.mirage_vs_fp32 \\
      --snr-db 45 --rrns [--device cpu]

1. RNS EXACTNESS (Section II-D): a BFP-mantissa GEMM computed through
   {31,32,33} residues + CRT equals the direct integer GEMM bit for bit.
2. GEMM ERROR (Section V-A sensitivity): BFP(b_m, g) quantization error vs
   FP32 for b_m in {3,4,5,6}, the shape of Fig. 5a's trade-off.
3. TRAINING PARITY (Table I): the same small LM trained under FP32 / bf16 /
   Mirage / INT8 — Mirage tracks FP32, INT8 lags.
4. NOISE + RRNS (Section VII, with --snr-db/--rrns): the analog channel at
   a finite detector SNR corrupts the uncorrected RNS GEMM; redundant-RNS
   majority decoding (``mirage_rrns``) recovers the accuracy.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import gemm, rns
from repro_torch.core.precision import MiragePolicy, get_policy
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.trainer import init_train_state, train_loop


def rns_exactness(device=None):
    print("=== 1. RNS exactness (residue GEMM + CRT == integer GEMM) ===")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = rng.integers(-15, 16, size=(8, 16)).astype(np.float32)
    w = rng.integers(-15, 16, size=(16, 8)).astype(np.float32)
    direct = x @ w
    via_rns = rns.rns_dot_reconstruct(torch.from_numpy(x).to(dev),
                                      torch.from_numpy(w).to(dev),
                                      k=5).cpu().numpy()
    print(f"  max |direct - rns| = {np.abs(direct - via_rns).max():.1f} "
          f"(exact: {np.array_equal(direct, via_rns)})")


def gemm_error(device=None):
    print("=== 2. BFP GEMM error vs b_m (cf. Fig 5a trade-off) ===")
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(32, 256)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32)).to(dev)
    ref = gemm.mirage_matmul_nograd(x, w, get_policy("fp32")).cpu().numpy()
    for b_m in (3, 4, 5, 6):
        p = MiragePolicy(mode="mirage_fast", b_m=b_m, g=16, k=max(5, b_m + 2))
        out = gemm.mirage_matmul_nograd(x, w, p).cpu().numpy()
        rel = np.abs(out - ref).max() / np.abs(ref).max()
        print(f"  b_m={b_m}: max rel err {rel:.4f}")


def training_parity(steps: int = 30, device=None, init=None):
    """Final losses by policy. ``init(model)`` may replace the weights
    drawn from seed 0 (the same for every policy)."""
    print("=== 3. Training parity (cf. Table I) ===")
    dev = resolve_device(device)
    cfg = get_config("qwen2-0.5b").reduced()
    data_cfg = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=48,
                                 batch_size=4)
    results = {}
    for name in ("fp32", "bf16", "mirage", "int8"):
        policy = get_policy(name)
        model = build_model(cfg, policy,
                            LMCallOptions(q_chunk=32, kv_chunk=32),
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(0))
        if init is not None:
            init(model)
        tc = TrainConfig(policy=policy, optimizer="adamw", lr=1e-3)
        state = init_train_state(model, tc)
        state, metrics = train_loop(model, tc, state,
                                    iter(SyntheticLM(data_cfg)), steps,
                                    log_every=0)
        results[name] = float(metrics["loss"])
        print(f"  {name:8s}: final loss {results[name]:.4f}")
    gap_mirage = results["mirage"] - results["fp32"]
    gap_int8 = results["int8"] - results["fp32"]
    print(f"  -> Mirage-FP32 gap {gap_mirage:+.4f}; "
          f"INT8-FP32 gap {gap_int8:+.4f}")
    return results


def noise_recovery(snr_db: float, with_rrns: bool, device=None,
                   draws=None):
    """The GEMM error rows at one SNR; ``draws`` as in
    :func:`repro_torch.analog.sweep.gemm_error_sweep`."""
    from repro_torch.analog import sweep
    print(f"=== 4. Analog channel @ {snr_db:g} dB SNR"
          + (" + RRNS correction" if with_rrns else "") + " ===")
    modes = ["mirage_rns_noisy"] + (["mirage_rrns"] if with_rrns else [])
    rows = sweep.gemm_error_sweep(snr_dbs=(snr_db,), modes=modes,
                                  shape=(16, 128, 16), seed=4, draws=draws,
                                  device=device)
    for r in rows:
        print(f"  {r['mode']:18s}: rel err {r['rel_fro_err']:.4f}, "
              f"corrupted outputs {r['corrupt_frac']*100:.1f}%")
    if with_rrns:
        print("  -> majority decoding over the redundant moduli repairs the"
              " single-residue errors the bare channel lets through")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snr-db", type=float, default=None,
                    help="detector SNR for the analog-channel demo (e.g. 45)")
    ap.add_argument("--rrns", action="store_true",
                    help="also run the RRNS-corrected backend in the demo")
    ap.add_argument("--skip-training", action="store_true",
                    help="skip the (slow) training-parity section")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    rns_exactness(args.device)
    gemm_error(args.device)
    if not args.skip_training:
        training_parity(device=args.device)
    if args.snr_db is not None or args.rrns:
        noise_recovery(args.snr_db if args.snr_db is not None else 45.0,
                       args.rrns, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
