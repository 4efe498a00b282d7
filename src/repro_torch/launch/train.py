"""Training launcher of the port (the twin of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 10 --policy mirage
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
      --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-large-v2 --steps 10

Trains the FULL-width config on the card unless ``--reduced`` is given,
with weights drawn from ``--seed`` and ``SyntheticLM`` batches of the JAX
launcher's defaults (batch 4, sequence 64, AdamW at lr 1e-3, grad clip
1.0, ``get_policy("mirage")``). Every forward, dX and dW GEMM runs through
the policy's backend (on the card, the hand-written BFP GEMM kernel).
``--device cpu`` runs the kernels' plain PyTorch versions instead.

``--weight-stationary-quant`` is the port's own flag (``TrainConfig``'s
field, which the JAX launcher does not expose): the GEMM weights are put on
the BFP grid once per step (the BFP quantizer kernel on the card) and the
policy skips their per-GEMM quantization.

``--arch`` takes the dense configs (command-r's parallel block included),
the vlm ``internvl2-2b`` (its batches carry the stub vision tower's
``patches`` from :func:`repro_torch.data.pipeline.with_extras`, as the JAX
launcher wraps its source) and the MoE configs (``qwen3-moe-30b-a3b``,
``mixtral-8x7b``: the expert stacks' forward, dX and dW GEMMs are each one
batched launch of the GEMM kernel), the SSM config ``mamba2-2.7b``
(whose 45.3 GB train state fits the card at full depth) and the hybrid
``zamba2-2.7b`` (54 Mamba2 layers and one shared attention block applied
after every 6th, its gradient summed over the 9 applications; a 39.0 GB
train state, which fits too) and the enc-dec ``seamless-m4t-large-v2``
(24 encoder and 24 decoder layers, a 26.1 GB train state; its batches
carry the stub speech frontend's ``frames``, one a token, from
:func:`repro_torch.data.pipeline.with_extras`). ``--layers N`` keeps the
config's first N layers at its published widths (an enc-dec config's
first N of each stack): the f32 train state (masters, gradients and both
Adam moments, 16 bytes a parameter) of a full-depth MoE config, or of
command-r-plus-104b, outgrows one card.

``--ckpt-dir DIR`` trains through the fault-tolerant loop: a checkpoint
every ``--ckpt-every`` steps (written on a writer thread) and one on
SIGTERM/SIGINT, after which the run stops; ``--resume`` continues from the
latest checkpoint in DIR, on the batch the stopped run would have taken
next (a vlm run's patch draws and an enc-dec run's frame draws start
over, as the JAX launcher's do).
Checkpoints are in the JAX package's layout, so either launcher resumes
the other's.

``--distributed`` trains ONE model over every rank of a torchrun launch,
the global batch split over them: the process group starts from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), each rank on ``cuda:LOCAL_RANK`` under NCCL (``--device
cpu``: the CPU under gloo), and the step runs sharded over a ``(data =
world, model = 1)`` mesh (:func:`repro_torch.runtime.trainer
.make_train_step` with ``mesh=``: FSDP over the ranks, the gradients
reduce-scattered), each rank reading the ``SyntheticLM`` shard of its data
coordinate (``--batch`` rows a rank). Two ranks that would share one card
under NCCL raise. The JAX launcher's ``--distributed`` initializes
``jax.distributed`` and shards the data by process, but attaches no
shardings, so its processes never exchange gradients; the port's trains
the one model the global batch defines. A checkpoint is written whole by
rank 0 and restores onto any rank count.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --distributed \
      --steps 10
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.data.pipeline import (SyntheticLM, SyntheticLMConfig,
                                       mesh_shard, with_extras)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.checkpoint import Checkpointer
from repro_torch.interop import restore_train_state
from repro_torch.runtime.elastic import (PreemptionGuard, StragglerMitigator,
                                         fault_tolerant_train_loop)
from repro_torch.runtime.trainer import (init_train_state, make_train_step,
                                         train_loop)



def _distributed_device(device_arg):
    """The rank's device and backend under torchrun: ``cuda:LOCAL_RANK``
    with NCCL, or the CPU with gloo for ``--device cpu``."""
    import os

    if device_arg is not None and torch.device(device_arg).type == "cpu":
        return torch.device("cpu"), "gloo"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("--distributed finds no CUDA card; run on the "
                           "CPU with --device cpu")
    if local >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local} names cuda:{local}, but this host has {n} "
            f"card(s): NCCL takes one rank a card, so two ranks would share "
            f"one. Start at most {n} ranks a host (torchrun "
            f"--nproc-per-node {n}), or run on the CPU with --device cpu")
    return torch.device("cuda", local), "nccl"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default="mirage",
                    help="fp32|bf16|int8|mirage|mirage_rns|"
                         "mirage_rns_noisy|mirage_rrns")
    ap.add_argument("--snr-db", type=float, default=None,
                    help="detector SNR for the analog-channel policies")
    ap.add_argument("--noise-seed", type=int, default=None,
                    help="static per-GEMM-site error pattern seed for "
                         "keyless noisy training")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--layers", type=int, default=None,
                    help="train only the config's first N layers, its "
                         "widths unchanged (a depth cut: the f32 train "
                         "state of a full-depth MoE config outgrows one "
                         "card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bfp"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--weight-stationary-quant", action="store_true",
                    help="quantize the GEMM weights once per step "
                         "(TrainConfig.weight_stationary_quant)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--trace-export", default=None, metavar="FILE",
                    help="enable the span tracer (train.step / "
                         "train.data_next / train.host_sync) and write a "
                         "Chrome-trace JSON here at exit")
    args = ap.parse_args(argv)
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")

    mesh = None
    shard_id, num_shards = 0, 1
    if args.distributed:
        from repro_torch.launch.mesh import init_distributed, make_debug_mesh
        from repro_torch.parallel.comm import MeshComm

        device, backend = _distributed_device(args.device)
        init_distributed(device, backend)
        world = torch.distributed.get_world_size()
        mesh = MeshComm(make_debug_mesh(world, 1, device=device,
                                        backend=backend), device)
        shard_id, num_shards = mesh_shard(mesh)
    else:
        device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=min(args.layers, cfg.n_layers),
            encoder_layers=min(args.layers, cfg.encoder_layers))
    overrides = {}
    if args.snr_db is not None:
        overrides["snr_db"] = args.snr_db
    if args.noise_seed is not None:
        overrides["noise_seed"] = args.noise_seed
    if args.weight_stationary_quant:
        overrides["assume_quantized_weights"] = True
    policy = get_policy(args.policy, **overrides)
    tc = TrainConfig(policy=policy, optimizer=args.optimizer, lr=args.lr,
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression, seed=args.seed,
                     weight_stationary_quant=args.weight_stationary_quant)
    model = build_model(cfg, policy, LMCallOptions(q_chunk=64, kv_chunk=64),
                        device=device, generator=torch.Generator(
                            device=device).manual_seed(args.seed))
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed, shard_id=shard_id, num_shards=num_shards))
    # on a mesh the step shards the model first, then the state is built
    step_fn = make_train_step(model, tc, mesh=mesh)
    state = init_train_state(model, tc)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, meta = restore_train_state(ckpt, model, state)
        if meta and "data" in meta:
            data.restore(meta["data"])
        print(f"resumed from step {int(state['step'])}")
    if cfg.frontend is not None:
        data = with_extras(data, cfg)

    if args.trace_export:
        from repro_torch.obs import trace as obs_trace
        obs_trace.configure(enabled=True)

    t0 = time.time()
    if ckpt:
        guard = PreemptionGuard()
        try:
            state, metrics = fault_tolerant_train_loop(
                model, tc, state, iter(data), args.steps, ckpt,
                ckpt_every=args.ckpt_every, guard=guard,
                straggler=StragglerMitigator(), step_fn=step_fn)
        finally:
            guard.uninstall()
    else:
        state, metrics = train_loop(model, tc, state, iter(data), args.steps,
                                    step_fn=step_fn)
    dt = time.time() - t0
    print(f"trained {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s) on {device}; final loss "
          f"{float(metrics['loss']):.4f}")
    if args.trace_export:
        from repro_torch.obs import trace as obs_trace
        tracer = obs_trace.get_tracer()
        tracer.export(args.trace_export)
        print(f"chrome trace ({tracer.n_recorded} spans) -> "
              f"{args.trace_export}")
    if args.distributed:
        torch.distributed.barrier()     # every rank done before any leaves
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
