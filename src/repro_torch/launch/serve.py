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

Robustness (the JAX launcher's flags): ``--chaos SPEC`` injects the seeded
fault schedule (SNR collapses, burst storms, stuck detector channels,
block-pool squeezes, prefill-worker crashes, host-transfer corruption: see
``repro_torch.runtime.faults``), its host sites seeded by
``--chaos-seed``; ``--guardian`` drains through the SNR guardian's
verify-before-commit windows of ``--guardian-window`` ticks
(``repro_torch.runtime.resilience``), escalating RRNS redundancy and
falling back to fp32 when the analog-health counters report uncorrectable
faults; ``--ttl-s`` / ``--queue-ttl-s`` give requests decode/admission
deadlines (terminal status ``timed_out``); ``--max-queue-depth`` caps
admission (rejected with a retry-after hint). For example, on the CPU::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --policy mirage_rrns --snr-db 60 \
      --chaos "snr_drop@0:100000:scale=1e6" --guardian

Meshed serving (the JAX launcher's ``--mesh-data``/``--mesh-model``):
``--distributed`` serves ONE engine over every rank of a torchrun launch
on a ``(--mesh-data, --mesh-model)`` mesh (``LMServer(mesh=...)``: the
weights cut over ``model``, the slots and the paged pools' blocks over
``data``), the process group from torchrun's environment; the world size
must be data x model. Each rank serves on ``cuda:LOCAL_RANK`` under NCCL,
one rank a card, or with ``--backend gloo`` ranks may share a card
(``cuda:LOCAL_RANK % cards``); ``--device cpu`` runs the ranks on the CPU
over gloo. Every rank runs the engine's host side in lockstep; rank 0
prints the mesh, the allocator's shards and placement, and the streams.
On a box with one card::

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --distributed \
      --mesh-data 2 --mesh-model 2 --backend gloo --cache-layout paged

Observability: ``--metrics-port P`` serves the engine's metrics registry
over HTTP (``/metrics`` Prometheus text, ``/metrics.json``, ``/trace``;
port 0 picks a free one); ``--trace-export F`` enables the span tracer and
writes a Chrome-trace JSON at exit; ``--profile-window DIR`` wraps the run
in a ``torch.profiler`` capture (``DIR/trace.json``) with the spans
annotated; ``--metrics-dump F`` writes the final registry snapshot as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.http import MetricsServer
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
                    help="retry budget for fault-aborted requests")
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
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus), /metrics.json and "
                         "/trace over HTTP on this port (0 = pick free)")
    ap.add_argument("--trace-export", default=None, metavar="FILE",
                    help="enable the span tracer and write Chrome-trace "
                         "JSON here at exit")
    ap.add_argument("--profile-window", default=None, metavar="LOGDIR",
                    help="capture a torch.profiler trace of the whole run "
                         "into this directory")
    ap.add_argument("--metrics-dump", default=None, metavar="FILE",
                    help="write the final metrics snapshot as JSON")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection schedule, e.g. "
                         "'snr_drop@4:12:scale=30;worker_crash@2;"
                         "pool_exhaustion@3:9:blocks=16' (see "
                         "repro_torch.runtime.faults)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the host-side fault sites (replays "
                         "bit-identically)")
    ap.add_argument("--guardian", action="store_true",
                    help="drain through the SNR guardian: verify-before-"
                         "commit windows over the analog-health counters, "
                         "escalating RRNS redundancy and falling back to "
                         "fp32 (requires --policy mirage_rrns + --snr-db)")
    ap.add_argument("--guardian-window", type=int, default=4,
                    help="decode ticks per guarded verify window")
    ap.add_argument("--ttl-s", type=float, default=None,
                    help="per-request end-to-end deadline: requests still "
                         "decoding past it retire as timed_out")
    ap.add_argument("--queue-ttl-s", type=float, default=None,
                    help="admission deadline: requests still queued past "
                         "it retire as timed_out")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission cap: reject submissions (with a "
                         "retry-after hint) past this queue depth")
    ap.add_argument("--distributed", action="store_true",
                    help="one engine over every rank of a torchrun launch, "
                         "on a (--mesh-data, --mesh-model) mesh")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' collectives (default: nccl on the "
                         "card, gloo on the CPU); gloo lets ranks share "
                         "a card")
    args = ap.parse_args(argv)
    if args.mesh_data < 1 or args.mesh_model < 1:
        ap.error("--mesh-data and --mesh-model must be >= 1")
    if args.mesh_data * args.mesh_model > 1 and not args.distributed:
        ap.error("--mesh-data/--mesh-model serve over processes, one a "
                 "rank: add --distributed and start the ranks with "
                 "torchrun")
    if args.distributed and args.engine == "oracle":
        ap.error("--distributed needs the batched engine")
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
    if args.engine == "oracle" and (args.chaos or args.guardian
                                    or args.max_queue_depth
                                    or args.ttl_s or args.queue_ttl_s):
        ap.error("--chaos/--guardian/--max-queue-depth/--ttl-s/--queue-ttl-s "
                 "need the batched engine")
    if args.guardian and args.policy != "mirage_rrns":
        ap.error("--guardian escalates RRNS redundancy; it needs "
                 "--policy mirage_rrns (plus --snr-db for a stochastic "
                 "channel worth guarding)")
    if args.guardian and args.pipeline_depth:
        ap.error("--guardian snapshots at window boundaries; drop "
                 "--pipeline-depth")
    return args


def build(args: argparse.Namespace, device=None):
    """The model the launcher serves: the config (reduced under
    ``--reduced``, cut to ``--layers``) with weights from seed 0 (the same
    on every rank), prefill attention through the flash kernel, on
    ``device`` (default ``--device``'s)."""
    device = resolve_device(args.device) if device is None else device
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


def distributed_mesh(args: argparse.Namespace):
    """``--distributed``: the rank's device and the ``(--mesh-data,
    --mesh-model)`` mesh over torchrun's process group (started here
    unless the caller started it); refuses a world size that is not data
    x model."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    if args.device is not None and torch.device(args.device).type == "cpu":
        device, backend = torch.device("cpu"), args.backend or "gloo"
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("--distributed finds no CUDA card; run on "
                               "the CPU with --device cpu")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        backend = args.backend or "nccl"
        if backend == "nccl" and local >= n:
            raise RuntimeError(
                f"LOCAL_RANK {local} names cuda:{local}, but this host has "
                f"{n} card(s): NCCL takes one rank a card. Start at most {n} "
                f"ranks a host, or pass --backend gloo to share cards")
        device = torch.device("cuda", local % n)
    init_distributed(device, backend)
    world = dist.get_world_size()
    if world != args.mesh_data * args.mesh_model:
        raise ValueError(
            f"a (data={args.mesh_data}, model={args.mesh_model}) mesh needs "
            f"{args.mesh_data * args.mesh_model} ranks; torchrun started "
            f"{world}")
    return device, make_debug_mesh(args.mesh_data, args.mesh_model,
                                   device=device, backend=backend)


def make_injector(args: argparse.Namespace):
    """The ``--chaos`` schedule's injector, or None."""
    if not args.chaos:
        return None
    from repro_torch.runtime.faults import FaultInjector, FaultSchedule
    schedule = FaultSchedule.parse(args.chaos)
    print(f"chaos: {schedule.describe()} (seed {args.chaos_seed})")
    return FaultInjector(schedule, seed=args.chaos_seed)


def serve(model, args: argparse.Namespace, injector=None, on_server=None,
          drain=None, mesh=None):
    """Serve the launcher's requests (prompts from seed 0, the first
    ``--shared-prefix`` tokens common to all) on ``model``'s device, under
    the ``--chaos`` ``injector``; ``on_server`` sees the engine before any
    request, ``drain(server)`` drains it (default ``run_until_drained``),
    inside the ``--profile-window``; returns (server, finished requests,
    seconds)."""
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
                          max_retries=args.max_retries,
                          fault_injector=injector,
                          max_queue_depth=args.max_queue_depth,
                          default_ttl_s=args.ttl_s,
                          default_queue_ttl_s=args.queue_ttl_s, mesh=mesh)
        if args.warmup:
            w = server.warmup()
            print(f"warmup: {w['compiled']:.0f} shapes run, "
                  f"{w['graphs']:.0f} graphs captured in "
                  f"{w['seconds']:.1f}s")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size,
                          min(args.shared_prefix,
                              args.prompt_len)).astype(np.int32)
    if on_server is not None:
        on_server(server)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            args.prompt_len - len(shared)).astype(np.int32)
        server.submit(Request(rid=rid, prompt=np.concatenate([shared, tail]),
                              max_tokens=args.max_tokens))
    profile = obs_trace.profile_window(args.profile_window,
                                       obs_trace.get_tracer()) \
        if getattr(args, "profile_window", None) else \
        contextlib.nullcontext()
    try:
        with profile:
            finished = drain(server) if drain is not None else \
                server.run_until_drained()
            if args.engine != "oracle":
                # every request retired here, those the guardian committed
                # in windows that were rolled back and replayed included
                finished = server.scheduler.finished
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
    if not args.distributed:
        return _main(args)
    import io

    import torch.distributed as dist
    started = not dist.is_initialized()
    device, mesh = distributed_mesh(args)
    # every rank serves; rank 0 reports
    out = contextlib.nullcontext() if dist.get_rank() == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with out:
        _main(args, device, mesh)
    if started:
        dist.barrier()
        dist.destroy_process_group()
    return 0


def _main(args, device=None, mesh=None):
    model = build(args, device)
    cfg, device = model.cfg, model.device
    injector = make_injector(args)
    if args.trace_export:
        obs_trace.configure(enabled=True)
    tracer = obs_trace.get_tracer()
    http_srv = None

    def start_metrics(server):
        nonlocal http_srv
        if args.metrics_port is None:
            return
        registry = getattr(server, "scheduler", None)
        http_srv = MetricsServer(
            port=args.metrics_port, tracer=tracer,
            registry=registry.registry if registry is not None else None)
        http_srv.start()
        print(f"metrics at {http_srv.url}/metrics (json: /metrics.json, "
              f"trace: /trace)")

    guardian = None

    def drain(server):
        nonlocal guardian
        if not args.guardian:
            return server.run_until_drained()
        from repro_torch.runtime.resilience import SNRGuardian
        guardian = SNRGuardian(server, window=args.guardian_window)
        return guardian.run_until_drained()

    server, finished, dt = serve(model, args, injector, start_metrics,
                                 drain, mesh)
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
    if args.engine == "batched":
        by_status = {}
        for r in finished:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        print(f"  terminal statuses: {by_status}")
    if guardian is not None:
        print(f"  guardian: level {guardian.level} "
              f"({len(guardian.transitions)} transitions)")
        for t in guardian.transitions:
            print(f"    {t}")
    if injector is not None and injector.log:
        print(f"  chaos log ({len(injector.log)} events):")
        for line in injector.log[:20]:
            print(f"    {line}")
    a = getattr(server, "alloc", None)
    if a is not None:
        print(f"  paged KV: block_size={a.block_size}, pool={a.n_blocks} "
              f"blocks, peak in use {a.peak_in_use} "
              f"({a.peak_in_use / a.n_blocks:.0%})")
    if mesh is not None:
        comm = model.comm
        print(f"  mesh: data={args.mesh_data} x model={args.mesh_model} "
              f"over {comm.backend} on {where}; collectives "
              f"{json.dumps(comm.stats.as_dict())}")
        if a is not None:
            print(f"  block shards: {a.n_shards} ({a.placement}), "
                  f"{a.local_allocs} local / {a.spilled_allocs} spilled "
                  f"allocations")
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
    for r in finished if mesh is not None else finished[:3]:
        print(f"  req {r.rid}: {r.tokens_out[:8]}...")
    if http_srv is not None:
        # self-scrape: the exposition endpoint round-trips before exit
        import urllib.request
        with urllib.request.urlopen(f"{http_srv.url}/metrics",
                                    timeout=5) as resp:
            n_series = sum(1 for ln in resp.read().decode().splitlines()
                           if ln and not ln.startswith("#"))
        print(f"  scraped {n_series} series from {http_srv.url}/metrics")
    if args.metrics_dump and args.engine == "batched":
        with open(args.metrics_dump, "w") as f:
            json.dump(server.scheduler.registry.snapshot(), f, indent=2)
        print(f"  metrics snapshot -> {args.metrics_dump}")
    if args.trace_export:
        tracer.export(args.trace_export)
        print(f"  chrome trace ({tracer.n_recorded} spans) -> "
              f"{args.trace_export}")
    if http_srv is not None:
        http_srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
