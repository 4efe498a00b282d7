"""Batched serving demo (the twin of ``examples/serve_lm.py``): the
continuous-batching engine (one decode step over a stacked slot cache) with
streaming token callbacks.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen2-0.5b

``--cache-layout paged`` serves from the block-table KV pool, on which
``--prefill-chunk``, ``--prefix-cache`` (the demo prompts share 8 tokens)
and ``--spec-k`` stack, as in the JAX script. Only the ported config
(qwen2-0.5b, reduced here as in the JAX script) builds. Whole-prompt
prefill attention runs through the flash kernel on the card.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=10)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--policy", default="mirage")
    ap.add_argument("--cache-layout", choices=("dense", "paged"),
                    default="dense",
                    help="paged = block-table KV pool for long-context memory")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="piggybacked prefill chunk size (paged only)")
    ap.add_argument("--block-size", type=int, default=4,
                    help="positions per KV block (paged only; small enough "
                         "that the demo's 8-token shared prefix spans "
                         "full blocks)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share matched prompt-prefix blocks copy-on-write "
                         "(paged only; the demo prompts share 8 tokens)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-draft + verify this many tokens per tick "
                         "(paged only, token-identical to greedy)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are emitted")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    if (args.prefix_cache or args.spec_k) and args.cache_layout != "paged":
        ap.error("--prefix-cache / --spec-k require --cache-layout paged")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    policy = get_policy(args.policy)
    model = build_model(cfg, policy,
                        LMCallOptions(q_chunk=32, kv_chunk=32,
                                      use_flash_kernel=True),
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    on_token = (lambda req, tok: print(f"  [req {req.rid}] -> {tok}")) \
        if args.stream else None
    server = LMServer(model, cap=args.prompt_len + args.max_tokens + 4,
                      batch_slots=args.slots, on_token=on_token,
                      cache_layout=args.cache_layout,
                      block_size=args.block_size,
                      prefill_chunk=args.prefill_chunk,
                      prefix_cache=args.prefix_cache,
                      spec_k=args.spec_k)

    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size,
                          min(8, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            args.prompt_len - len(shared)).astype(np.int32)
        server.submit(Request(
            rid=rid,
            prompt=np.concatenate([shared, tail]),
            max_tokens=args.max_tokens))
    finished = server.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens_out) for r in finished)
    lat = server.scheduler.latency_summary()
    print(f"{args.arch}: {len(finished)} requests, {toks} tokens, "
          f"{toks/dt:.1f} tok/s, {server.metrics['ticks']} decode ticks, "
          f"TTFT {lat['ttft_mean_s']*1e3:.1f}ms, "
          f"TPOT {lat['tpot_mean_s']*1e3:.1f}ms")
    if args.prefix_cache:
        print(f"  prefix hits: {server.metrics['prefix_hits']} "
              f"({server.metrics['prefix_shared_blocks']} blocks shared)")
    if args.spec_k:
        m = server.metrics
        print(f"  spec accepted/tick: "
              f"{m['spec_accepted'] / max(m['spec_slot_ticks'], 1):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
