"""Serving launcher of the port: the continuous-batching engine on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --layers 12
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch command-r-plus-104b --layers 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --cache-layout paged

Serves the FULL-width config unless ``--reduced`` is given (``--layers N``
keeps its first N layers: the MoE configs' and command-r-plus-104b's f32
weights outgrow one card at full depth; internvl2-2b serves text-only, as
the JAX engine does; mamba2-2.7b serves at full depth, its recurrent state
in place of KV, so ``--cache-layout paged`` keeps no pool and
``--prefix-cache`` shares nothing, as in the JAX engine; zamba2-2.7b
serves at full depth too, its shared attention block's KV paged under
``--cache-layout paged`` while ``--prefix-cache`` still shares nothing,
and ``--layers N`` keeps N // 6 applications of that block; the enc-dec
seamless-m4t-large-v2 raises ``ValueError``: as in the JAX package, no
engine serves it, and its served path is ``EncDec.prefill`` and
``EncDec.decode_step``), with weights and prompts drawn from seed 0,
through
``LMServer`` (greedy unless
``--sample``; whole-prompt prefill attention through the flash kernel),
and prints tok/s, TTFT and TPOT. ``--device cpu`` runs the kernels' plain
PyTorch versions instead (slow at full width).

``--engine oracle`` serves through the per-slot parity loop instead of the
batched engine. ``--cache-layout paged`` keeps KV in a pool of
``--n-blocks`` blocks of ``--block-size`` positions behind per-slot block
tables; on it, ``--prefill-chunk N`` streams prompts through the decode
loop N tokens a tick, ``--prefix-cache`` shares matched prompt-prefix
blocks copy-on-write (``--shared-prefix N`` gives the synthetic prompts a
common first N tokens, so that it hits), and ``--spec-k K`` drafts K tokens
a tick and verifies them in one step (greedy only; token for token what
greedy decode emits).

``--warmup`` runs every serving shape once before traffic and, on the
card, captures the tick as a CUDA graph that every later tick replays;
``--pipeline-depth N`` overlaps up to N bucketed prefills with decode on a
worker thread (on a CUDA stream of its own); ``--max-retries`` bounds the
retries of requests whose prefill job failed.

``--snr-db`` serves through the analog channel at that detector SNR (with
``--policy mirage_rns_noisy`` or ``mirage_rrns``), its noise seeded by
``--noise-seed``; a stochastic policy also prints the analog-health
counters.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, PerSlotLMServer, Request


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="mirage")
    ap.add_argument("--engine", choices=("batched", "oracle"),
                    default="batched")
    ap.add_argument("--cache-layout", choices=("dense", "paged"),
                    default="dense",
                    help="paged = block-table KV pool (memory scales with "
                         "live tokens, not slots x cap)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="positions per KV block (paged layout)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="block-pool size (default: slots * ceil(cap/block) "
                         "= no saving but never exhausts)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="stream prompts through decode ticks in chunks of "
                         "this many tokens (requires --cache-layout paged)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share matched prompt-prefix blocks copy-on-write "
                         "across slots (requires --cache-layout paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="first N prompt tokens identical across the "
                         "synthetic requests (makes --prefix-cache hit)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: self-draft this many tokens "
                         "per tick, verify in one step (paged + greedy)")
    ap.add_argument("--block-placement", choices=("locality", "round_robin"),
                    default="locality",
                    help="block placement of the paged pool's allocator "
                         "(one shard here: both place alike)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every (bucket, batch) prefill shape plus "
                         "tick/verify before traffic, and capture the tick "
                         "as a CUDA graph on the card")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="overlap up to this many bucketed prefills with "
                         "decode on a worker thread (0 = synchronous)")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="retry budget of requests whose prefill job "
                         "failed")
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
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the config's first N layers (its "
                         "widths unchanged)")
    args = ap.parse_args(argv)
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")
    if args.engine == "oracle" and args.sample:
        ap.error("--sample needs the batched engine (the per-slot oracle "
                 "is greedy-only)")
    if args.engine == "oracle" and (args.cache_layout != "dense" or
                                    args.prefill_chunk or args.prefix_cache
                                    or args.spec_k):
        ap.error("--cache-layout paged / --prefill-chunk / --prefix-cache / "
                 "--spec-k need the batched engine")
    if (args.prefix_cache or args.spec_k) and args.cache_layout != "paged":
        ap.error("--prefix-cache / --spec-k require --cache-layout paged")
    if args.spec_k and args.sample:
        ap.error("--spec-k verifies against greedy argmax; drop --sample")
    if args.engine == "oracle" and (args.warmup or args.pipeline_depth):
        ap.error("--warmup/--pipeline-depth need the batched engine")
    return args


def build(args: argparse.Namespace):
    """The model the launcher serves: the config (reduced under
    ``--reduced``, cut to ``--layers``) with weights from seed 0, prefill
    attention through the flash kernel."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.arch_id}: the serving engine takes decoder-only models; "
            f"the JAX package's engine serves no enc-dec model either. Its "
            f"served path is the model's own EncDec.prefill(frames, tokens, "
            f"cap) and greedy EncDec.decode_step(cache, tokens)")
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=min(args.layers,
                                                    cfg.n_layers))
    overrides = {}
    if args.snr_db is not None:
        overrides.update(snr_db=args.snr_db, noise_seed=args.noise_seed)
    return build_model(cfg, get_policy(args.policy, **overrides),
                       LMCallOptions(use_flash_kernel=True), device=device)


def serve(model, args: argparse.Namespace):
    """Serve the launcher's requests (prompts from seed 0, the first
    ``--shared-prefix`` tokens common to all) on ``model``'s device;
    returns (server, finished requests, seconds)."""
    cfg = model.cfg
    cap = args.prompt_len + args.max_tokens + 4
    if args.engine == "oracle":
        server = PerSlotLMServer(model, cap=cap, batch_slots=args.slots)
    else:
        server = LMServer(model, cap=cap, batch_slots=args.slots,
                          greedy=not args.sample,
                          cache_layout=args.cache_layout,
                          block_size=args.block_size,
                          n_blocks=args.n_blocks,
                          prefill_chunk=args.prefill_chunk,
                          prefix_cache=args.prefix_cache,
                          spec_k=args.spec_k,
                          block_placement=args.block_placement,
                          pipeline_depth=args.pipeline_depth,
                          max_retries=args.max_retries)
        if args.warmup:
            w = server.warmup()
            print(f"warmup: {w['compiled']:.0f} shapes run, "
                  f"{w['graphs']:.0f} graphs captured in "
                  f"{w['seconds']:.1f}s")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size,
                          min(args.shared_prefix,
                              args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            args.prompt_len - len(shared)).astype(np.int32)
        server.submit(Request(rid=rid, prompt=np.concatenate([shared, tail]),
                              max_tokens=args.max_tokens))
    try:
        finished = server.run_until_drained()
    finally:
        if args.engine != "oracle":
            server.close()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return server, finished, time.perf_counter() - t0


def _latency(finished):
    """Mean/p50/p99 TTFT and TPOT (ms) over the finished requests."""
    out = {}
    for name in ("ttft", "tpot"):
        arr = np.asarray([getattr(r, name) for r in finished
                          if r.t_first_token > 0] or [0.0]) * 1e3
        out[name] = (float(arr.mean()), float(np.percentile(arr, 50)),
                     float(np.percentile(arr, 99)))
    return out


def main(argv=None):
    args = parse_args(argv)
    model = build(args)
    cfg, device = model.cfg, model.device
    server, finished, dt = serve(model, args)
    tot_toks = sum(len(r.tokens_out) for r in finished)
    lat = _latency(finished)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[{cfg.arch_id} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"{args.policy} {args.engine} on {where}] served {len(finished)} "
          f"requests, {tot_toks} tokens in {dt:.2f}s "
          f"({tot_toks / dt:.1f} tok/s); {server.metrics['ticks']} ticks")
    print("  TTFT mean/p50/p99: {:.1f}/{:.1f}/{:.1f}ms; TPOT mean/p50/p99: "
          "{:.2f}/{:.2f}/{:.2f}ms".format(*lat["ttft"], *lat["tpot"]))
    a = getattr(server, "alloc", None)
    if a is not None:
        print(f"  paged KV: block_size={a.block_size}, pool={a.n_blocks} "
              f"blocks, peak in use {a.peak_in_use} "
              f"({a.peak_in_use / a.n_blocks:.0%})")
    m = server.metrics
    if args.prefix_cache:
        print(f"  prefix cache: {m['prefix_hits']} hits "
              f"({m['prefix_full_hits']} full), "
              f"{m['prefix_shared_blocks']} blocks shared")
    if args.spec_k:
        per = m["spec_accepted"] / max(m["spec_slot_ticks"], 1)
        print(f"  speculative k={args.spec_k}: {m['spec_accepted']} tokens "
              f"accepted over {m['spec_slot_ticks']} slot-ticks "
              f"({per:.2f}/tick)")
    health = server.health_snapshot() if args.engine == "batched" else {}
    if health:
        print(f"  analog health: {health}")
    for r in finished[:3]:
        print(f"  req {r.rid}: {r.tokens_out[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
