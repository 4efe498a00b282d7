"""The ranks of ``tests/test_torch_serving_mesh.py``: 4 gloo processes on
the CPU over a 2x2 (data, model) mesh. Each rank serves every case on one
device (the reference) and on the mesh (and qwen2 under mirage sampled,
``greedy=False``), and rank 0 writes what it found under OUTDIR for the
test process to check.

  PYTHONPATH=src python tests/_torch_serve_ranks.py OUTDIR

Imports torch and the port only (no JAX), so each rank starts in seconds.
The requests and engine settings are the JAX package's meshed test's
(``tests/test_serving_mesh.py``): reduced configs, cap 64, 4 slots,
buckets (16,), paged blocks of 16 in a pool of 32.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch

WORLD = 4

#: the JAX meshed test's five cases, and qwen2 under fp32 on dense rings
CASES = (("qwen2-0.5b", "mirage", "paged"),
         ("qwen2-0.5b", "mirage_rrns", "paged"),
         ("mixtral-8x7b", "mirage", "paged"),
         ("mamba2-2.7b", "mirage", "dense"),
         ("zamba2-2.7b", "mirage", "dense"),
         ("qwen2-0.5b", "fp32", "dense"))

#: chunked prefill, the prefix cache and speculative decoding on
#: ``round_robin`` blocks: every slot reads pages homed on the other shard
OPTIONS = dict(prefill_chunk=8, prefix_cache=True, spec_k=2,
               block_placement="round_robin")

#: the launcher's flags (with ``--distributed --mesh-data 2 --mesh-model 2
#: --device cpu`` on the mesh)
LAUNCH = ["--reduced", "--requests", "4", "--prompt-len", "12",
          "--max-tokens", "6", "--cache-layout", "paged", "--block-size",
          "8"]


def policy_of(pol: str):
    from repro_torch.core.precision import get_policy
    if pol == "mirage_rrns":
        # a stochastic channel: the meshed ranks draw the one-device noise
        return get_policy(pol, snr_db=52.0, noise_seed=7)
    return get_policy(pol)


def build(arch: str, pol: str):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    return build_model(get_config(arch).reduced(), policy_of(pol),
                       LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu",
                       generator=torch.Generator().manual_seed(0))


def requests(cfg, n=6, max_tokens=8, shared=0):
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size, shared).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate([head, rng.integers(
        0, cfg.vocab_size, 4 + 2 * i if shared else 12).astype(np.int32)]),
        max_tokens=max_tokens) for i in range(n)]


def engine(model, mesh, layout="paged", **kw):
    from repro_torch.runtime.server import LMServer
    if layout == "paged":
        kw = dict(dict(block_size=16, n_blocks=32), **kw)
    return LMServer(model, cap=64, batch_slots=4, buckets=(16,), mesh=mesh,
                    cache_layout=layout, **kw)


def streams(server):
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.scheduler.finished}


def drain(server, reqs):
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    return streams(server)


def exported_health(server):
    """The ``serve_health_*`` lines of the engine's metrics exposition."""
    return [ln for ln in server.scheduler.registry.prometheus_text()
            .splitlines() if ln.startswith("serve_health_")]


def run_case(comm, arch, pol, layout, shared=0, **kw):
    """(one-device streams, meshed streams, meshed engine) of one case."""
    cfg = build(arch, pol).cfg
    one = engine(build(arch, pol), None, layout, **kw)
    single = drain(one, requests(cfg, shared=shared))
    comm.stats.reset()
    srv = engine(build(arch, pol), comm, layout, **kw)
    meshed = drain(srv, requests(cfg, shared=shared))
    srv.single_health = one.health_snapshot()
    srv.single_exported = exported_health(one)
    return single, meshed, srv


def check_cases(rank, comm, out):
    found = {}
    for arch, pol, layout in CASES:
        single, meshed, srv = run_case(comm, arch, pol, layout)
        found[(arch, pol, layout)] = {
            "single": single, "meshed": meshed,
            "health": srv.health_snapshot(),
            "single_health": srv.single_health,
            "exported": exported_health(srv),
            "single_exported": srv.single_exported,
            "exchanged": comm.stats.bytes["page_exchange"]}
        if (arch, pol, layout) == CASES[0]:
            a = srv.alloc
            a.check_invariants()
            found["alloc"] = {
                "n_shards": a.n_shards, "local": a.local_allocs,
                "spilled": a.spilled_allocs,
                "remote": a.remote_fraction(),
                "exchanged": comm.stats.bytes["page_exchange"],
                "local_pool": tuple(srv.state["cache"]["kp"].shape),
                "local_slots": tuple(srv.state["last_tok"].shape)}
    single, meshed, _ = run_case(comm, "qwen2-0.5b", "mirage", "paged",
                                 greedy=False)
    found["sampled"] = {"single": single, "meshed": meshed}
    single, meshed, srv = run_case(comm, "qwen2-0.5b", "mirage", "paged",
                                   shared=32, **OPTIONS)
    srv.alloc.check_invariants()
    found["options"] = {"single": single, "meshed": meshed,
                        "exchanged": comm.stats.bytes["page_exchange"],
                        "hits": srv.metrics["prefix_hits"],
                        "remote": srv.alloc.remote_fraction(),
                        "spec_ticks": srv.metrics["spec_ticks"]}
    if rank == 0:
        torch.save(found, os.path.join(out, "cases.pt"))


def check_snapshots(rank, comm, out):
    """A snapshot taken on the mesh resumes on one device, and one taken on
    one device resumes on the mesh, each equal to the uninterrupted
    streams."""
    arch, pol = "qwen2-0.5b", "mirage_rrns"
    cfg = build(arch, pol).cfg
    whole = drain(engine(build(arch, pol), None), requests(cfg))
    found = {"whole": whole}
    for src_mesh, dst_mesh, name in ((comm, None, "mesh_to_one"),
                                     (None, comm, "one_to_mesh")):
        a = engine(build(arch, pol), src_mesh)
        for r in requests(cfg):
            a.submit(r)
        for _ in range(4):
            a.tick()
        snap = a.snapshot()
        b = engine(build(arch, pol), dst_mesh)
        b.restore(snap)
        b.run_until_drained()
        found[name] = streams(b)
    if rank == 0:
        torch.save(found, os.path.join(out, "snapshots.pt"))


def check_refusals(rank, comm, out):
    found = {}
    srv = engine(build("qwen2-0.5b", "mirage"), comm)
    try:
        srv.warmup()
    except NotImplementedError as e:
        found["warmup"] = str(e)
    try:
        engine(build("qwen2-0.5b", "mirage"), comm, "dense",
               pipeline_depth=1)
    except NotImplementedError as e:
        found["pipeline"] = str(e)
    if rank == 0:
        torch.save(found, os.path.join(out, "refusals.pt"))


def check_launcher(rank, comm, out):
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(LAUNCH + ["--device", "cpu", "--distributed",
                             "--mesh-data", "2", "--mesh-model", "2"])
    with open(os.path.join(out, f"launch_{rank}.txt"), "w") as f:
        f.write(buf.getvalue())


CHECKS = (check_cases, check_snapshots, check_refusals, check_launcher)


def run_rank(rank: int, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.parallel.comm import MeshComm

    torch.set_num_threads(1)
    init_distributed("cpu", "gloo", rank=rank, world_size=WORLD,
                     store=dist.FileStore(os.path.join(out, "store"), WORLD))
    comm = MeshComm(make_debug_mesh(2, 2, device="cpu"), "cpu")
    for fn in CHECKS:
        fn(rank, comm, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(run_rank, args=(sys.argv[1],), nprocs=WORLD)
