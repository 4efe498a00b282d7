"""Serving launcher of the port: the continuous-batching engine on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b

Serves the FULL-width config unless ``--reduced`` is given, with weights
and prompts drawn from seed 0, through the dense-layout ``LMServer``
(greedy unless ``--sample``; prefill attention through the flash kernel),
and prints tok/s, TTFT and TPOT. ``--device cpu`` runs the kernels' plain
PyTorch versions instead (slow at full width).

``--snr-db`` serves through the analog channel at that detector SNR (with
``--policy mirage_rns_noisy`` or ``mirage_rrns``), its noise seeded by
``--noise-seed``; a stochastic policy also prints the analog-health
counters.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, Request


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="mirage")
    ap.add_argument("--snr-db", type=float, default=None,
                    help="serve through the analog channel at this SNR "
                         "(use with --policy mirage_rns_noisy/mirage_rrns)")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="base seed for per-tick analog noise")
    ap.add_argument("--sample", action="store_true",
                    help="categorical sampling instead of greedy argmax")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny test variant of the config")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The model the launcher serves: the config (reduced under
    ``--reduced``) with weights from seed 0, prefill attention through the
    flash kernel."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {}
    if args.snr_db is not None:
        overrides.update(snr_db=args.snr_db, noise_seed=args.noise_seed)
    return build_model(cfg, get_policy(args.policy, **overrides),
                       LMCallOptions(use_flash_kernel=True), device=device)


def serve(model, args: argparse.Namespace):
    """Serve the launcher's requests (prompts from seed 0) on ``model``'s
    device; returns (server, finished requests, seconds)."""
    cfg = model.cfg
    cap = args.prompt_len + args.max_tokens + 4
    server = LMServer(model, cap=cap, batch_slots=args.slots,
                      greedy=not args.sample)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        server.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_tokens=args.max_tokens))
    finished = server.run_until_drained()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return server, finished, time.perf_counter() - t0


def main(argv=None):
    args = parse_args(argv)
    model = build(args)
    cfg, device = model.cfg, model.device
    server, finished, dt = serve(model, args)
    tot_toks = sum(len(r.tokens_out) for r in finished)
    lat = server.scheduler.latency_summary()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[{cfg.arch_id} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"{args.policy} on {where}] served {len(finished)} requests, "
          f"{tot_toks} tokens in {dt:.2f}s ({tot_toks / dt:.1f} tok/s); "
          f"{server.metrics['ticks']} ticks")
    print(f"  TTFT mean/p50/p99: {lat['ttft_mean_s']*1e3:.1f}/"
          f"{lat['ttft_p50_s']*1e3:.1f}/{lat['ttft_p99_s']*1e3:.1f}ms; "
          f"TPOT mean/p50/p99: {lat['tpot_mean_s']*1e3:.2f}/"
          f"{lat['tpot_p50_s']*1e3:.2f}/{lat['tpot_p99_s']*1e3:.2f}ms")
    health = server.health_snapshot()
    if health:
        print(f"  analog health: {health}")
    for r in finished[:3]:
        print(f"  req {r.rid}: {r.tokens_out[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
