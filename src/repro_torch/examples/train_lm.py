"""End-to-end training script (the twin of ``examples/train_lm.py``): a
~100M-parameter LM for a few hundred steps with the full stack — Mirage
numerics, microbatched gradient accumulation, BFP gradient compression,
fault-tolerant checkpointing and deterministic resumable data.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 --small

Stop it mid-run (Ctrl-C or SIGTERM) and run it again with --resume: it
checkpoints on preemption and continues from the exact batch it would
have seen. Checkpoints go to ``build/mirage_train_lm`` at the root of the
checkout unless ``--ckpt-dir`` says otherwise; they are in the JAX
package's layout, so ``examples/train_lm.py --resume`` reads them too.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.interop import restore_train_state
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.elastic import (PreemptionGuard, StragglerMitigator,
                                         fault_tolerant_train_loop)
from repro_torch.runtime.trainer import init_train_state

DEFAULT_CKPT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
                    / "mirage_train_lm")


def lm_100m() -> ModelConfig:
    """~100M dense LM (qwen2-style GQA family)."""
    return ModelConfig(
        arch_id="lm-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=2, d_ff=2560, vocab_size=16000, head_dim=64,
        qkv_bias=True, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--policy", default="mirage")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = lm_100m()
    if args.small:
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=256, d_ff=1024,
                                  vocab_size=4000, n_heads=4, n_kv_heads=2)
    n_params_est = (cfg.vocab_size * cfg.d_model
                    + cfg.n_layers * (3 * cfg.d_model * cfg.d_ff
                                      + 2 * cfg.d_model * cfg.d_model
                                      + 2 * cfg.d_model * cfg.n_kv_heads
                                      * cfg.resolved_head_dim))
    print(f"model ~{n_params_est/1e6:.0f}M params, policy={args.policy}")

    policy = get_policy(args.policy)
    tc = TrainConfig(policy=policy, optimizer="adamw", lr=3e-4,
                     microbatches=args.microbatches,
                     grad_compression="bfp")   # error-feedback BFP all-reduce
    model = build_model(cfg, policy, LMCallOptions(q_chunk=64, kv_chunk=64),
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(model, tc)

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch))
    ckpt = Checkpointer(args.ckpt_dir, keep_last=2)
    if args.resume and ckpt.latest_step() is not None:
        state, meta = restore_train_state(ckpt, model, state)
        if meta and "data" in meta:
            data.restore(meta["data"])
        print(f"resumed at step {int(state['step'])}")

    guard = PreemptionGuard()
    try:
        state, metrics = fault_tolerant_train_loop(
            model, tc, state, iter(data), args.steps, ckpt, ckpt_every=25,
            guard=guard, straggler=StragglerMitigator())
    finally:
        guard.uninstall()
    print(f"done at step {int(state['step'])}: "
          f"loss={float(metrics['loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
