"""The ranks of ``tests/test_torch_distributed.py``: 4 gloo processes on
the CPU over a 2x2 (data, model) mesh, each running every sharded check
once and writing what it found under OUTDIR for the test process to hold
against the single-device port.

  PYTHONPATH=src python tests/_torch_dist_ranks.py OUTDIR

Imports torch and the port only (no JAX), so each rank starts in seconds.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

WORLD = 4
SEQ = 32

#: the checks, each a function of (rank, comm, out_dir)
CHECKS = {}


def check(fn):
    CHECKS[fn.__name__] = fn
    return fn


def qwen2():
    from repro_torch.configs import get_config
    return get_config("qwen2-0.5b").reduced()


def train_batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, SEQ)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (4, SEQ)).astype(
                np.int32)}


def train_config(variant: str):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.precision import get_policy

    if variant == "wsq":
        policy = get_policy("mirage", assume_quantized_weights=True)
        return TrainConfig(policy=policy, lr=1e-3,
                           weight_stationary_quant=True)
    return TrainConfig(policy=get_policy("mirage"), lr=1e-3,
                       grad_compression="bfp" if variant == "bfp" else "none")


def build(cfg, policy, **opt):
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    return build_model(cfg, policy, LMCallOptions(q_chunk=16, kv_chunk=16,
                                                  **opt),
                       device="cpu",
                       generator=torch.Generator().manual_seed(0))


class ShapeTap:
    """(M, K, N) of every 2-D GEMM the model runs while open (forward, dX
    and dW: each is one call of ``core.gemm._forward_impl``)."""

    def __init__(self):
        from repro_torch.core import gemm
        self.gemm, self.shapes = gemm, []

    def __enter__(self):
        inner = self.inner = self.gemm._forward_impl

        def tapped(x, w, *a, **k):
            if w.dim() == 2:
                self.shapes.append((int(x.numel() // x.shape[-1]),
                                    int(w.shape[0]), int(w.shape[1])))
            return inner(x, w, *a, **k)
        self.gemm._forward_impl = tapped
        return self

    def __exit__(self, *exc):
        self.gemm._forward_impl = self.inner


class GradTap:
    """The step's gradients while open: summed over the data ranks, before
    compression and clipping (what ``runtime.trainer._reduce_grads``
    returns in every step, with a mesh or without)."""

    def __enter__(self):
        from repro_torch.runtime import trainer
        self.trainer, self.inner, self.grads = trainer, \
            trainer._reduce_grads, None

        def tapped(*a, **k):
            self.grads = self.inner(*a, **k)
            return self.grads
        trainer._reduce_grads = tapped
        return self

    def __exit__(self, *exc):
        self.trainer._reduce_grads = self.inner


def merged_arch():
    """Reduced command-r with its parallel block's projections merged."""
    from repro_torch.configs import get_config
    return get_config("command-r-plus-104b").reduced(), \
        {"merge_parallel_proj": True}


def _train(rank, comm, out, variant):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.interop import to_jax_train_state
    from repro_torch.parallel.shard import gather_train_state, local_batch
    from repro_torch.runtime.trainer import init_train_state, make_train_step

    cfg, opt = merged_arch() if variant == "merged" else (qwen2(), {})
    tc = train_config(variant)
    model = build(cfg, tc.policy, **opt)
    step = make_train_step(model, tc, mesh=comm)
    state = init_train_state(model, tc)
    with ShapeTap() as tap, GradTap() as gtap:
        state, metrics = step(state, local_batch(train_batch(cfg), comm))
    full = gather_train_state(model, state)
    grads = {k: model.placements[k].full(g) for k, g in gtap.grads.items()}
    if variant == "mirage":
        ck = Checkpointer(os.path.join(out, "ckpt"))
        ck.save(to_jax_train_state(model, state), step=1)
    if rank == 0 or variant == "mirage":
        torch.save({"loss": metrics["loss"], "grad_norm":
                    metrics["grad_norm"], "state": full, "grads": grads,
                    "shapes": tap.shapes},
                   os.path.join(out, f"train_{variant}_{rank}.pt"))


@check
def train_mirage(rank, comm, out):
    _train(rank, comm, out, "mirage")


@check
def train_bfp(rank, comm, out):
    _train(rank, comm, out, "bfp")


@check
def train_wsq(rank, comm, out):
    _train(rank, comm, out, "wsq")


@check
def train_merged(rank, comm, out):
    _train(rank, comm, out, "merged")


@check
def elastic(rank, comm, out):
    """The 2x2 checkpoint of ``train_mirage`` onto a 1x4 mesh."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.interop import restore_train_state
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.comm import MeshComm
    from repro_torch.parallel.shard import gather_train_state
    from repro_torch.runtime.trainer import init_train_state, make_train_step

    cfg = qwen2()
    tc = train_config("mirage")
    model = build(cfg, tc.policy)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    mesh14 = MeshComm(make_debug_mesh(1, 4, device="cpu"), "cpu")
    make_train_step(model, tc, mesh=mesh14)
    state = init_train_state(model, tc)
    state, _ = restore_train_state(Checkpointer(os.path.join(out, "ckpt")),
                                   model, state)
    full = gather_train_state(model, state)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    if rank == 0:
        torch.save({"state": full, "local_shapes": shapes},
                   os.path.join(out, "elastic_0.pt"))


@check
def decode(rank, comm, out):
    """Reduced mixtral: prefill on one device, then one decode step with
    the params and the cache sharded by the rules."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.parallel.shard import shard_cache, shard_model

    cfg = get_config("mixtral-8x7b").reduced()
    model = build(cfg, get_policy("mirage"))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))
                            .astype(np.int64))
    with torch.no_grad():
        logits, cache = model.prefill(toks, 16)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1)
        shard_model(model, comm)
        local = shard_cache(cache, comm, cfg)
        n = nxt.shape[0] // comm.dp
        l2, _ = model.decode_step(local, nxt[comm.dp_rank * n:
                                             (comm.dp_rank + 1) * n])
    torch.save({"logits": l2, "cache_k": local["k"].shape},
               os.path.join(out, f"decode_{rank}.pt"))


def _moe(rank, comm, out, impl, factor):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models import moe
    from repro_torch.parallel.shard import local_rows, shard_model
    from repro_torch.runtime.trainer import _reduce_grads

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              n_layers=1)
    model = build(cfg, get_policy("mirage"))
    shard_model(model, comm)
    layer = model.layers[0].moe
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model))
                         .astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model))
                         .astype(np.float32))
    xl = local_rows(x, comm).clone().requires_grad_(True)
    fn = moe.moe_apply_ep if impl == "ep" else moe.moe_apply
    y, aux = fn(layer, xl, get_policy("mirage"), n_experts=cfg.n_experts,
                experts_per_token=cfg.experts_per_token,
                capacity_factor=factor, comm=comm)
    names = [f"layers.0.moe.{k}" for k in ("router.w", "gate", "up", "down")]
    params = [model.get_parameter(k) for k in names]
    # the objective sum(y * r) + aux over the global batch: each data rank
    # holds its rows' part and 1/dp of the (global) aux
    grads = torch.autograd.grad(
        torch.sum(y * local_rows(r, comm)) + aux / comm.dp, params + [xl])
    g = _reduce_grads(dict(zip(names, grads[:-1])), model.placements, comm)
    g = {k: model.placements[k].full(v) for k, v in g.items()}
    torch.save({"y": y.detach(), "aux": aux.detach(), "grads": g,
                "dx": grads[-1]},
               os.path.join(out, f"moe_{impl}_{factor}_{rank}.pt"))


@check
def moe_dp(rank, comm, out):
    _moe(rank, comm, out, "dp", 1.25)


@check
def moe_ep(rank, comm, out):
    _moe(rank, comm, out, "ep", 8.0)
    _moe(rank, comm, out, "ep", 1.25)


def run_rank(rank: int, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.parallel.comm import MeshComm

    torch.set_num_threads(1)
    init_distributed("cpu", "gloo", rank=rank, world_size=WORLD,
                     store=dist.FileStore(os.path.join(out, "store"), WORLD))
    comm = MeshComm(make_debug_mesh(2, 2, device="cpu"), "cpu")
    for name, fn in CHECKS.items():
        fn(rank, comm, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(run_rank, args=(sys.argv[1],), nprocs=WORLD)
