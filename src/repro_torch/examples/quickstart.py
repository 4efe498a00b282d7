"""Quickstart (the twin of ``examples/quickstart.py``): train a small LM
with Mirage (BFP) numerics.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

What this shows:
  1. every GEMM (forward AND backward) runs the paper's BFP(b_m=4, g=16)
     quantization through ``mirage_matmul``'s autograd Function (on the
     card, the hand-written BFP GEMM kernel);
  2. FP32 master weights are updated by a plain FP32 optimizer (paper
     Eq. 4);
  3. the loss goes down just like FP32 training (paper Table I's claim, at
     demo scale).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.trainer import init_train_state, train_loop


def run(device=None, steps: int = 40, log_every: int = 5, init=None):
    """The quickstart's training run; returns the trained model and the
    last step's metrics. ``init(model)`` may replace the weights drawn
    from seed 0."""
    dev = resolve_device(device)
    cfg = get_config("qwen2-0.5b").reduced()   # tiny same-family config
    policy = get_policy("mirage")              # the paper's operating point
    print(f"policy: {policy.mode} b_m={policy.b_m} g={policy.g} "
          f"moduli={policy.moduli} (M={policy.rns_M})")

    model = build_model(cfg, policy, LMCallOptions(q_chunk=32, kv_chunk=32),
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    if init is not None:
        init(model)
    tc = TrainConfig(policy=policy, optimizer="adamw", lr=1e-3)
    state = init_train_state(model, tc)

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=48, batch_size=4))
    state, metrics = train_loop(model, tc, state, iter(data), n_steps=steps,
                                log_every=log_every)
    print(f"final loss {float(metrics['loss']):.4f} — "
          f"Mirage numerics train like FP32.")
    return model, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
