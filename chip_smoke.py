"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card (the BFP quantizer bit
for bit on both of its routes; the fused GEMM at every
split of K its wrapper picks for a serving shape, in both weight layouts,
and bitwise equal across two launches; flash attention at the path's
prefill shapes and its edge cases; the RRNS decode bit for bit, also
where every element runs all subsets), serves full-width
qwen2-0.5b (random weights from a seed) through the port's ``LMServer`` on
each ported path — ``mirage_fast`` (the BFP GEMM kernel), ``mirage_rrns`` at
52 dB detector SNR (the residue GEMM with its fused readout channel and the
RRNS decode), its clean-channel twin and ``mirage_rns`` (the residue GEMM)
— checks that each path launched exactly the expected kernels (and that
the RRNS path's health counters are the reference run's integers), and
times every kernel at the shapes the serving paths give it, with only the
device's work inside the timing window (flash beside the fastest
scaled_dot_product_attention backend that takes the call). Each phase prints one
JSON line; any failed check exits non-zero. The last line is the device
record. Without CUDA, or without the repository's ``src`` beside it, the
script exits non-zero and prints no result.

Slice 2 (training): the GEMM kernel at every dX and dW shape of a training
step (the head's too, a ragged token count, and the weight-stationary
forward and dX on the trainer's own pre-quantized layout), then full-width
qwen2-0.5b trained as ``python -m repro_torch.launch.train`` trains it
(batch 4 x 64 tokens, AdamW, ``mirage``) for 10 steps, with every forward,
dX and dW GEMM counted through the kernel and 2 steps profiled; fp32
training (at 8 of its 24 layers) held to the CPU end to end and step 1's
gradients leaf by leaf
(with a TF32 control the limits must catch), mirage training
teacher-forced GEMM by GEMM; weight-stationary training with BFP gradient
compression (the BFP quantizer kernel on its path; its GEMMs
teacher-forced too); and the backward GEMMs timed.

Closing slice 2: the flash kernel at head dims 16, 24 (padded to the 32
instance), 80 and 128 (and each instance's registers and spills from
``nvcc -Xptxas -v``, built beside the extension), ``python -m
repro_torch.launch.serve --reduced`` through the flash kernel at head_dim
16 (under fp32, greedy streams equal to the CPU's), full-width mirage
training through ``launch.train`` (at 8 of 24 layers from PR 26) stopped
by SIGTERM at step 2 and resumed with ``--resume``, bit for bit equal to
4 straight steps (then the full-width state's checkpoint bytes and its
save and restore times), 2 full-width
``mirage_rns`` steps with kernel 4 launched over group blocks (peak memory
under 24 GB, step 1's GEMMs teacher-forced against mirage_fast), and the
four example twins (``python -m repro_torch.examples.*``) on the card.
Checkpoints go to ``build/chip_smoke_ckpt`` and are removed after.

Slice 5 (the paged serving engine): the GEMM kernel also at the verify
step's M = 16 (4 slots x 4 positions) and a prefill chunk's M = 32; the
slice's requests served through the paged engine (block size 4, so the
gathered span equals the dense ring's: the streams must be the dense
engine's, token for token, with the same launches; then block size 16 on
a pool of half the default, which queues admissions for blocks), the
52 dB mirage_rrns drain through the paged engine (the dense drain's
streams and health integers), and 8 requests sharing a 64-token prefix
through five engines (dense; paged with chunked prefill, with the prefix
cache, with speculative decoding, with all three; at 8 of the 24 layers
from PR 26): under fp32 each engine's streams equal the dense engine's
(or differ first where the dense logits' top-2 gap is under 1e-4), under
mirage the GEMM launches equal 7 x layers + 1 x the engine's own count
of model steps.

The rest of slice 5: each path's requests through a warmed engine against
a cold one (mirage_fast dense, paged at block size 4, paged with spec_k
= 3, and mirage_rrns at 52 dB): the warmed engine replays its tick as one
CUDA graph, and its streams, launch counts (and RRNS health integers)
must equal the cold drain's, with the steady tick of both timed in turns
and profiled; the slice's requests through pipeline_depth = 2 (the
prefill's flash kernels on the worker's own stream, the streams equal to
the synchronous drain's); a paged drain that grows from 2 to 4 slots and
shrinks and regrows its block pool (the streams of a fixed 4-slot engine
fed the same arrivals); and a mirage_rrns drain switched to mirage after
8 ticks (the card's memory drops by the stationary residues), beside a
mirage -> mirage switch that leaves slice's streams as they were.

Slice 6a (the MoE family): the GEMM kernel batched over a stack of E
experts in one launch at every expert GEMM shape of the MoE paths (and
ragged ones), bitwise equal to E unbatched launches with the same plan,
then qwen3-moe-30b-a3b (12 of 48 layers) and mixtral-8x7b (4 of 32) at
their published widths, served under mirage cold, warmed and (qwen3-moe)
paged, the streams equal, every expert stack one launch, the steady tick
timed and profiled, and the first layer teacher-forced against
the CPU with the routing choices that differ and their margins.

Slice 6b (MoE training): the GEMM kernel at every expert stack of a
training step of both MoE configs (dX on the stack's (E, N, K) view, dW
on X^T with the ragged contraction C, the weight-stationary forward and
dX on the trainer's layout), bitwise equal to E single-expert launches
and a repeat; qwen3-moe-30b-a3b (4 of 48 layers, 10 steps) and
mixtral-8x7b (2 of 32, 3 steps) trained as ``launch.train --arch ...
--layers N`` trains them, every expert stack's forward, dX and dW one
launch, two steps from one state bitwise equal; qwen3-moe's expert
stacks at 1 layer teacher-forced against the CPU (with the routing on
the CPU's router input) and 1 layer under fp32 held to the CPU; both
configs at 1 layer under weight-stationary quantization with BFP
gradient compression, every kernel-1 and kernel-2 launch counted, layer
0's GEMMs teacher-forced against the CPU.

Slice 6c (the MoE family under the paper's datapath): kernels 4, 5 and 6
at the expert stacks' blocks of both MoE configs (decode and prefill;
qwen3-moe's gate/up at decode one launch of 81,920 (modulus, expert,
group) slots; a block of whole experts sliced in place; the readout
noise one expert-shaped draw read at a group period), bit for bit against
their plain versions and timed; both configs (2 layers and 1) served
under mirage_rrns at 52 dB with the default engine (weights encoded per
call), its clean twin (equal streams, no decode beyond the radius), the
steady tick cold against warmed, and a short mirage_rns drain; both with
stationary weights (every expert stack programmed once) at 2 and 1
layers; and 2 mirage_rns training steps of qwen3-moe at 1 layer. Every
launch is held to the residue blocks the backends ran.

Slice 6d (command-r's parallel block and the vlm frontend): kernel 1 at
the new shapes of these paths (internvl2's untied head at its odd
vocabulary N = 92,553, whose rows are not 16-byte aligned; the head's dX
in training, contracting over K = 92,553; command-r's widths and its
merged projection) and flash at a GQA group of 12 (96 query heads over 8
kv heads), each against its plain version and timed; internvl2-2b at its
published widths and full depth served under mirage cold and warmed, one
prefill led by 256 projected patches with decode steps from its cache,
mirage_rrns at 52 dB against its clean twin, and layers 0 and 23 and the
head teacher-forced against the CPU; internvl2-2b trained at full depth
on ``with_extras``' patches (10 steps, two steps from one state bitwise
equal, the projector's and layer 0's fp32 gradients teacher-forced
against the CPU); command-r-plus-104b at 4 of 64 layers served cold and
warmed, each layer's ``merge_parallel_proj`` projection held to the two
it replaces, layer 0 teacher-forced against the CPU.

Slice 6e (the SSM family): kernel 1 at mamba2-2.7b's shapes (the decode
tick's in_proj 2,560 -> 10,576 with its ragged last column tile, out_proj
and the untied head; a prefill's projections; each one's training dX and
dW), each against its plain version and timed; mamba2-2.7b at its
published widths, cut to 16 of 64 layers from PR 25 (full depth in PR
24), served under mirage cold and warmed (prefill batches of one exact
prompt length; every slot's ``ssm`` and ``conv`` state carried in place,
inside the captured tick too), its first and last layers and head
teacher-forced against the CPU, and at 2 layers
under fp32 its logits and its decode after a prefill held to the CPU and
to the prefill of the longer prompt; at 8 layers the paged (no page
pool), chunked (exact-length final chunks), prefix-flagged (inert),
speculative (the state rolled back to the accepted token), pipelined,
per-slot, resized and switched engines against the dense engine's
streams; at 16 layers mirage_rrns at 52 dB against its clean twin with
stationary weights; and training at 16 layers (10 steps, two steps from one
state bitwise equal, layer 0's fp32 gradients teacher-forced against the
CPU).

Slice 6f (the hybrid family): kernel 1 at zamba2-2.7b's shapes (in_proj
2,560 -> 10,448, the shared block's proj, attention and MLP, the head;
prefill; the training dX and dW) and flash at the shared block's D = 80
with 32 heads over 32 kv heads, each against its plain version and
timed; zamba2-2.7b at its published widths and full depth (54 Mamba2
layers, one shared attention + MLP block applied after every 6th, 9
times, on concat(hidden, embeddings)) served under mirage cold and warmed
(kernel 1 181 times a model step, flash 9 times a prefill batch), one
shared application timed alone, layers 0, 5 and 53 (each with its shared
application) and the head teacher-forced against the CPU, and at 12
layers under fp32 its logits and its decode after a prefill held to the
CPU; at 6 layers (from PR 26) every engine (the paged ones building the
shared KV's pool; the resize on the paged layout) against the dense
engine's streams, at 12 mirage_rrns at 52 dB against its clean twin with
the health integers counting the Mamba2 and head GEMMs alone; and
full-depth training (10 steps, 543 kernel-1 launches a step, two steps from one
state bitwise equal, layer 5's and the shared block's fp32 gradients
teacher-forced against the CPU).

Slice 6g (the enc-dec family): flash non-causal (the encoder's
bidirectional attention; in the flash check and timed at its served shape,
4 x 1,024 frames, 16 heads over 16 of 64) and kernel 1 at
seamless-m4t-large-v2's shapes (the decode step's projections, GELU MLP
and untied head at N = 256,206; the encoder's prefill GEMMs at M = 4,096;
the head's training dX and dW), each against its plain version and
timed; seamless-m4t-large-v2 at its published widths and full depth (24
encoder and 24 decoder layers) served as both packages serve it, the
model's own prefill (4 rows of 1,024 frames, 16-token prompts) and 31
greedy decode steps under mirage (kernel 1 386 times a prefill and 193 a
step, flash 48 times a prefill), the decode step's wall, busy and idle
time against its byte bound; encoder layers 0 and 23, decoder layers 0
and 23 and the head teacher-forced against the CPU under mirage and
fp32, and at 6 + 6 layers under fp32 its logits and its decode after a
prefill against the CPU; at 4 + 4 layers mirage_rrns at 52 dB against
its clean twin with stationary weights, every GEMM call in the health
scope; and full-depth training (1,157 kernel-1 launches a step, two steps
from one state bitwise equal, frontend_proj's, encoder layer 0's and
decoder layers 0's and 23's fp32 gradients teacher-forced, each leaf
held against an f64 reference beside the CPU's f32).

Slice 7 (fault-managed serving): kernels 4 and 6 at n_mod 7 (the
guardian's r = 4 rung: moduli 31, 32, 33, 37, 41, 43, 47, 35 subsets) bit
for bit against their plain versions at every slice GEMM shape and timed
(rows 4c, 6c); full-width qwen2-0.5b under mirage_rrns at 52 dB served
under a seeded chaos schedule (4 requests of 16 prompt tokens): the SNR
guardian under an SNR collapse streaming exactly the fp32 engine's tokens
(the ladder walked r=2 -> r=4 -> fp32), the unguarded collapse reporting
uncorrected decodes, a transient hole escalated and probed back down,
every GEMM under the open fault scope through kernel 4 and the plain
readout, then kernel 6, and kernel 5 never; width-1 burst storms and a
stuck redundant channel corrected to the clean twin's streams, cold and
warmed (the captured tick reading the live controls); a crashed prefill
job, a squeezed pool and a corrupted payload on the paged, pipelined
engine retried to the clean streams; queue and decode deadlines, the
admission cap, a snapshot resumed by a fresh warmed engine with the
uninterrupted streams and health, and the metrics exporter on loopback.

Slice 8a (sharded training): kernel 1 at qwen2-0.5b's TP = 2 shard
shapes (forward, dX and dW at M = 128 and 256) against its plain version,
gate/up and down timed (row 1h); then 4 ranks spawned on the one card over
gloo (NCCL takes one rank a card), a (data 2, model 2) mesh: 3 mirage
steps of full-width qwen2-0.5b (507 kernel-1 launches a rank a step at the
shard shapes, collective bytes by kind, peak memory a rank) with the
step-1 loss held to one device's, one fp32 step held to one device's leaf
by leaf; ``moe_apply_ep`` over qwen3-moe-30b-a3b's first layer at full
width against the single-device ``moe_apply``, dropless and per data
shard; a 2x2 train state restored onto 1x4 and one device bit for bit;
``launch.train --distributed`` as one NCCL rank, and a second rank on the
card refused.

Run as a script, it pins the CPU side's vector dispatch (ATen at AVX2,
MKL's conditional reproducibility at AVX2) before importing torch, so the
CPU references do not depend on the host's own dispatch level.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import hashlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Optional

if __name__ == "__main__":
    # The CPU side's plain versions are the references of the card-vs-CPU
    # gates. Pin ATen's vector dispatch and MKL's code path (before torch is
    # imported), so that their bits do not depend on the host's CPU: the
    # plain qwen2-0.5b layers take other bits under the host's own AVX-512
    # dispatch than under AVX2, and moved by up to 0.0079 relative L2 under
    # ATEN_CPU_CAPABILITY=default.
    os.environ.setdefault("ATEN_CPU_CAPABILITY", "avx2")
    os.environ.setdefault("MKL_CBWR", "AVX2,STRICT")

import numpy as np
import torch

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
SPIN_CYCLES = 4_000_000       # the unit of device spin ahead of a timed call

SLOTS, N_REQUESTS, MAX_TOKENS = 4, 8, 32
PROMPT_LENS = (17, 128)       # inclusive range of the numpy-seeded lengths
GEMM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 151936))
GEMM_M = (4, 8, 256, 512)
# the paged engine's new M: a verify tick (4 slots x (k + 1) = 16 rows) and
# a prefill chunk of 32 tokens
PAGED_GEMM_M = (16, 32)
# the (M, K, N) GEMMs checked in the transposed layout as well: the tied
# head's table is (N, K), the layer weights (K, N)
GEMM_BOTH_LAYOUTS = ((4, 4864, 896), (512, 896, 4864), (4, 896, 151936))
# launches of each GEMM shape per decode tick (= per prefill batch): q and o
# are 896->896, k and v 896->128, gate and up 896->4864, down 4864->896, per
# layer x 24, plus the tied head 896->151936 once
GEMM_PER_STEP = {(896, 896): 48, (896, 128): 48, (896, 4864): 48,
                 (4864, 896): 24, (896, 151936): 1}
TF32_FLOPS_PER_S = 494.7e12   # H100 SXM TF32 tensor cores, dense
# (B, L, H, Kv, D, window): the checked attention shapes: the path's prefill
# shapes (batches of 1, 2 and 4 prompts in the 32, 64 and 128 buckets),
# L = 1, a partial 16-row warp tile (L = 17), no GQA (Kv = H), windows at
# and inside a 32-key tile, and longer rows
FLASH_CASES = ((4, 128, 14, 2, 64, None), (4, 512, 14, 2, 64, None),
               (4, 77, 14, 2, 64, None), (4, 128, 14, 2, 64, 32),
               (1, 32, 14, 2, 64, None), (2, 64, 14, 2, 64, None),
               (4, 64, 14, 2, 64, None), (2, 1, 14, 2, 64, None),
               (2, 17, 14, 2, 64, None), (2, 77, 14, 14, 64, None),
               (4, 128, 14, 2, 64, 40), (1, 300, 8, 2, 64, 45))
# the other head dims: instances 16, 80 and 128 and a padded 24 (to 32),
# each with GQA at L = 1, 17, 128 (a window inside a tile) and 512, and
# without GQA (the reduced config's 4 heads over 2 kv heads at D = 16)
FLASH_DIMS = (16, 24, 80, 128)
FLASH_CASES += tuple(case for D in FLASH_DIMS for case in (
    (2, 1, 14, 2, D, None), (2, 17, 14, 2, D, None),
    (4, 128, 14, 2, D, 40), (2, 512, 14, 2, D, None),
    (2, 77, 4, 4, D, None), (4, 32, 4, 2, D, None)))
# the non-causal cases (the enc-dec encoder's bidirectional attention, from
# PR 26): its served shape (16 heads over 16 at D = 64, 1,024 frames), one
# row, L = 1 and a partial 16-row warp tile, GQA, and the other instances
FLASH_NONCAUSAL = ((4, 1024, 16, 16, 64), (1, 1024, 16, 16, 64),
                   (2, 1, 16, 16, 64), (2, 17, 16, 16, 64),
                   (2, 77, 14, 2, 64), (1, 300, 8, 2, 64),
                   (2, 77, 4, 4, 16), (2, 128, 32, 32, 80),
                   (2, 77, 14, 2, 128))
# the timed attention shapes (the first is the headline row; the last three
# the other instances at the headline shape)
FLASH_TIMED = ((4, 128, 14, 2, 64, None), (1, 32, 14, 2, 64, None),
               (2, 64, 14, 2, 64, None), (4, 64, 14, 2, 64, None),
               (4, 77, 14, 2, 64, None), (4, 512, 14, 2, 64, None),
               (4, 128, 14, 2, 64, 32), (4, 128, 14, 2, 16, None),
               (4, 128, 14, 2, 80, None), (4, 128, 14, 2, 128, None))

# the RNS paths: base moduli (k = 5), base + the two redundant RRNS moduli,
# and a k = 8 set for the residue kernel's range; M = 4 is a decode tick,
# M = 512 the largest prefill batch (4 prompts in the 128 bucket)
RNS_BASE, RRNS_ALL, RNS_K8 = (31, 32, 33), (31, 32, 33, 37, 41), \
    (255, 256, 257)
RNS_M = (4, 512)
SNR_DB, NOISE_SEED = 52.0, 7
INT_OPS_PER_S = F32_FLOPS_PER_S   # int32 on the CUDA cores: the f32 rate
RNS_TOKENS, RNS_REQUESTS = 8, 4   # the shorter mirage_rns drain
CAP = PROMPT_LENS[1] + MAX_TOKENS + 4   # the engine's cache length
# the health counters of slice_rrns at 52 dB and noise seed 7: a run must
# give these integers. The detector flips are the residues the noise moved,
# counted by the fused readout kernel itself (wrapped against clean, as the
# JAX package's default route counts them); counted from the draw,
# round(n) % m != 0, modulus 41 read 30172, two more than moved, at the two
# f32 ties below. rrns_corrected counts the elements whose residues moved,
# bit-exact given the residues; but at two elements of modulus 41 the f32
# sum res + n is exactly a half-integer and rounds half to even, so whether
# they move follows the residue's parity, and with it the f32 rounding of
# every kernel upstream (`--audit-rrns-health` lists them): 32095 with the
# CUDA-core flash kernel that preceded the tensor-core one, 32094 with it
RRNS_HEALTH = {"detector_flips": [1, 14, 45, 1864, 30170],
               "rrns_corrected": 32094, "rrns_uncorrected": 0}

# symbols of the port's kernels in a profiler trace
PORT_KERNEL_SYMBOLS = ("gemm_decode_kernel", "gemm_mma_kernel",
                       "gemm_stream_kernel", "stream_prep_kernel",
                       "splitk_reduce_kernel", "flash_fwd_kernel",
                       "rns_matmul_kernel", "rns_matmul_slots_kernel",
                       "rrns_decode_kernel",
                       "bfp_fake_quant_kernel", "bfp_fake_quant_vec_kernel")


class CheckFailed(RuntimeError):
    pass


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``t_s``, the seconds since
    the script started (the last line, the device record, stays as it is)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: timed calls whose host enqueue outlasted the device spin ahead of them
TIMER_OVERRUNS = []


@functools.lru_cache(maxsize=1)
def spin_ms() -> float:
    """Device time of one spin of SPIN_CYCLES (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end), 1e-3)


#: how the plain versions are timed: once after one warm-up. They are the
#: reference of each check, not a yardstick of speed (the library call is),
#: and the script's time limit is shared by every phase
PLAIN_TIMING = dict(n=1, warmup=1)


def time_ms(fn, n: int = 20, warmup: int = 3, flush_l2: bool = True) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls (CUDA
    events), with the 50 MB L2 cache flushed before each call, as the
    serving path finds a layer's weights cold. A device spin, enqueued after
    the flush and before the start event and at least twice as long as the
    host takes to enqueue ``fn``, keeps the device behind the host, so the
    event window holds the call's device work and not the host's enqueue
    (checks, allocation, binding). Calls whose enqueue still outlasts the
    spin (a plain version that waits for the device) are listed in
    TIMER_OVERRUNS."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    cycles = SPIN_CYCLES * min(50, max(1, math.ceil(2 * enqueue_ms /
                                                    spin_ms())))
    times = []
    for _ in range(n):
        if flush_l2:
            scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin = torch.cuda.Event(enable_timing=True)
        spin.record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        times.append(start.elapsed_time(end))
        if host_ms > spin.elapsed_time(start):
            TIMER_OVERRUNS.append((getattr(fn, "__name__", "?"), host_ms))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    return bound_rate(bytes_moved, flops, F32_FLOPS_PER_S)


def bound_rate(bytes_moved: float, ops_: float, ops_per_s: float):
    """The least time for the work (ms) and what sets it: the bytes at the
    HBM rate, or the operations at ``ops_per_s``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: the BFP quantizer, bit for bit
# --------------------------------------------------------------------------

def bfp_inputs(rows: int, k: int, seed: int) -> torch.Tensor:
    """Magnitudes over 1e-8..1e8, negatives, zero groups, subnormal elements
    and groups whose max is subnormal."""
    rng = np.random.default_rng(seed)
    x = rng.choice([-1.0, 1.0], size=(rows, k)) * \
        10.0 ** rng.uniform(-8, 8, size=(rows, k))
    x = x.astype(np.float32)
    g = 16
    n_groups = rows * (k // g)
    flat = x[:, :(k // g) * g].reshape(n_groups, g)
    pick = rng.choice(n_groups, size=max(3, n_groups // 50), replace=False)
    third = len(pick) // 3
    flat[pick[:third]] = 0.0                                   # zero groups
    flat[pick[third:2 * third]] = (rng.choice([-1.0, 1.0], (third, g)) *
                                   rng.uniform(1e-45, 1.17e-38, (third, g))
                                   ).astype(np.float32)        # subnormal max
    sub = pick[2 * third:]
    flat[sub, 3] = np.float32(-3e-39)                          # subnormals
    flat[sub, 7] = np.float32(1e-44)
    x[:, :(k // g) * g] = flat.reshape(rows, -1)
    return torch.from_numpy(x).to(DEV)


def bfp_cases():
    """(rows, K, g, rounding, misaligned, route) of the checked quantizer
    runs: the headline matrix, the vector route at every power-of-two g up
    to 128, with a partial last group and with idle lanes (g = 12), and the
    scalar route at g = 256, at K % 4 != 0 and on a view 4 bytes off a
    16-byte boundary; truncation on both routes."""
    cases = [(4096, 4864, 16, "nearest", False, "vector"),
             (8, 896, 16, "nearest", False, "vector")]
    cases += [(64, 4864, g, "nearest", False, "vector")
              for g in (4, 8, 32, 64, 128)]
    cases += [(64, 900, 16, "nearest", False, "vector"),
              (64, 900, 12, "nearest", False, "vector"),
              (64, 4864, 16, "truncate", False, "vector"),
              (64, 4864, 256, "nearest", False, "scalar"),
              (64, 898, 16, "nearest", False, "scalar"),
              (64, 4864, 16, "nearest", True, "scalar"),
              (64, 898, 16, "truncate", False, "scalar")]
    return cases


def bfp_operand(rows: int, k: int, seed: int, misaligned: bool):
    """bfp_inputs, or the same values in a view one float past a 16-byte
    boundary (contiguous, so the wrapper takes it, but not float4-aligned)."""
    x = bfp_inputs(rows, k, seed)
    if not misaligned:
        return x
    buf = torch.empty(rows * k + 1, device=DEV)
    view = buf[1:].view(rows, k)
    view.copy_(x)
    return view


def phase_bfp(ops, ref):
    worst = 0
    for i, (rows, k, g, rounding, misaligned, route) in enumerate(
            bfp_cases()):
        policy = options_policy(4, g, rounding)
        x = bfp_operand(rows, k, i + 1, misaligned)
        planned = ops.bfp_quant_plan(k, g, x.data_ptr() % 16 == 0)
        got = ops.bfp_fake_quant(x, policy)
        want = ref.bfp_fake_quant_ref(x, policy.b_m, policy.g,
                                      policy.rounding)
        torch.cuda.synchronize()
        mismatches = int((got.view(torch.int32) !=
                          want.view(torch.int32)).sum())
        n_sub = int(((x != 0) & (x.abs() < 1.1754944e-38)).sum())
        ok = mismatches == 0 and planned == route
        emit({"phase": "bfp_bitexact", "shape": [rows, k], "g": g,
              "rounding": rounding, "misaligned_view": misaligned,
              "route": planned, "mismatching_bits_elements": mismatches,
              "subnormal_inputs": n_sub, "ok": ok})
        check(planned == route, f"bfp_quant_plan picked the {planned} route "
                                f"for ({rows}, {k}) g={g}, expected {route}")
        check(mismatches == 0, f"BFP kernel differs from the plain version "
                               f"in {mismatches} elements at ({rows}, {k}) "
                               f"g={g} {rounding} ({route} route)")
        worst = max(worst, float((got - want).abs().max()))
    return worst


# --------------------------------------------------------------------------
# phase 4: the fused GEMM against its plain version
# --------------------------------------------------------------------------

def gemm_operands(M: int, K: int, N: int, seed: int,
                  w_nk: Optional[bool] = None):
    """x (M, K) and w (K, N): contiguous, or the transpose of a contiguous
    (N, K) table where ``w_nk`` (by default for the tied head's shape)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=DEV)
    if w_nk is None:
        w_nk = N == 151936
    if w_nk:
        # the tied head passes emb.T: a transposed (N, K) table, read in place
        w = (torch.randn((N, K), generator=gen, device=DEV) * 0.02).T
    else:
        w = torch.randn((K, N), generator=gen, device=DEV) / math.sqrt(K)
    return x, w


def folded(ref, x, w, policy):
    xq = ref.bfp_fake_quant_ref(x, policy.b_m, policy.g)
    wq = ref.bfp_fake_quant_ref(w.T, policy.b_m, policy.g).T
    return xq, wq


def path_gemm_ms(cap: int):
    """Every M the serving paths give each GEMM shape: the decode tick's
    SLOTS rows, prefill batches of a power-of-two count of prompts times a
    length bucket, and the head's last positions (1, 2 or 4 prompts)."""
    from repro_torch.runtime.server import default_buckets

    batches = [1 << i for i in range(SLOTS.bit_length()) if 1 << i <= SLOTS]
    prefill = sorted({b * L for b in batches for L in default_buckets(cap)})
    layer_ms = sorted({SLOTS, *prefill})
    return {(K, N): batches if N == 151936 else layer_ms
            for K, N in GEMM_KN}


def card_gemm_plan(ops, M: int, K: int, N: int, b_m: int,
                   quant_w: bool = True):
    """The wrapper's plan for this GEMM on this card."""
    return ops.gemm_plan(M, N, K, b_m, ops.sm_count(torch.device(DEV)),
                         quant_w)


def gemm_cases(ops, policy, cap: int):
    """(M, K, N, w_nk) of the checked GEMMs: GEMM_M x GEMM_KN, the
    GEMM_BOTH_LAYOUTS in the other layout too, and one M for each plan
    (route, block size, split of K, rows held) that the wrapper picks for a
    path shape and the cases before do not already cover."""
    cases = [(M, K, N, N == 151936) for M in GEMM_M + PAGED_GEMM_M
             for K, N in GEMM_KN]
    cases += [(M, K, N, N != 151936) for M, K, N in GEMM_BOTH_LAYOUTS]

    def key(M, K, N, w_nk):
        plan = card_gemm_plan(ops, M, K, N, policy.b_m)
        rows = None if plan.mma else (4 if M <= 4 else 8 if M <= 8 else 16)
        return plan[:4], rows, w_nk

    seen = {key(*c) for c in cases}
    for (K, N), ms in path_gemm_ms(cap).items():
        for M in ms:
            c = (M, K, N, N == 151936)
            if key(*c) not in seen:
                seen.add(key(*c))
                cases.append(c)
    return cases


def phase_gemm(ops, ref, policy):
    worst = 0.0
    for M, K, N, w_nk in gemm_cases(ops, policy, CAP):
        x, w = gemm_operands(M, K, N, seed=M * 7 + K + N, w_nk=w_nk)
        got = ops.mirage_matmul_fused(x, w, policy)
        again = ops.mirage_matmul_fused(x, w, policy)
        want = ref.mirage_gemm_ref(x, w, policy.b_m, policy.g)
        xq, wq = folded(ref, x, w, policy)
        tol = 1e-5 * (xq.abs() @ wq.abs()) + 1e-30
        err = (got - want).abs()
        bad = int((err > tol).sum())
        same = bool(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)))
        torch.cuda.synchronize()
        plan = card_gemm_plan(ops, M, K, N, policy.b_m)
        emit({"phase": "gemm_vs_plain", "M": M, "K": K, "N": N,
              "w_layout": "NK" if w_nk else "KN",
              "route": "mma_bf16" if plan.mma else "decode_f32",
              "threads": plan.threads, "splits": plan.splits,
              "k_split": plan.k_split, "blocks": plan.blocks,
              "max_abs_err": float(err.max()),
              "max_err_over_tol": float((err / tol).max()),
              "bitwise_repeatable": same, "ok": bad == 0 and same})
        check(bad == 0, f"GEMM kernel outside |got-ref| <= 1e-5 "
                        f"(|xq|@|wq|) + 1e-30 in {bad} elements at "
                        f"M={M} K={K} N={N} w_nk={w_nk}")
        check(same, f"two launches of the GEMM differ at M={M} K={K} N={N} "
                    f"w_nk={w_nk}")
        worst = max(worst, float(err.max()))
        del x, w, got, again, want, xq, wq, tol, err
    return worst


def options_policy(b_m: int, g: int, rounding: str):
    """``mirage`` at other BFP settings, with the smallest special-moduli k
    whose RNS range holds the output (Eq. 10): the GEMM kernel ignores k."""
    from repro_torch.core.precision import get_policy

    for k in range(5, 16):
        try:
            return get_policy("mirage", b_m=b_m, g=g, rounding=rounding, k=k)
        except ValueError:
            continue
    raise ValueError(f"no k holds b_m={b_m} g={g}")


def phase_gemm_options(ops, ref):
    """The GEMM kernel at every g that divides 64, truncation, b_m up to 8
    (both routes) and b_m = 12 (the CUDA-core route at any M), on ragged
    shapes: K not a multiple of 64 (and of 4: 4-byte copies) and N not a
    multiple of 4, in both weight layouts."""
    shapes = ((3, 198, 70, False), (3, 200, 72, True), (40, 200, 70, False),
              (40, 198, 72, True))
    for g in (1, 2, 4, 8, 16, 32, 64):
        for b_m, rounding in ((4, "nearest"), (2, "truncate"),
                              (8, "nearest"), (12, "nearest")):
            policy = options_policy(b_m, g, rounding)
            worst, bad, same = 0.0, 0, True
            for i, (M, K, N, w_nk) in enumerate(shapes):
                x, w = gemm_operands(M, K, N, seed=600 + i, w_nk=w_nk)
                got = ops.mirage_matmul_fused(x, w, policy)
                same &= bool(torch.equal(got, ops.mirage_matmul_fused(
                    x, w, policy)))
                want = ref.mirage_gemm_ref(x, w, b_m, g, rounding)
                xq = ref.bfp_fake_quant_ref(x, b_m, g, rounding)
                wq = ref.bfp_fake_quant_ref(w.T, b_m, g, rounding).T
                tol = 1e-5 * (xq.abs() @ wq.abs()) + 1e-30
                err = (got - want).abs()
                bad += int((err > tol).sum())
                worst = max(worst, float((err / tol).max()))
            torch.cuda.synchronize()
            emit({"phase": "gemm_options_vs_plain", "g": g, "b_m": b_m,
                  "rounding": rounding, "shapes": [list(c) for c in shapes],
                  "max_err_over_tol": worst, "bitwise_repeatable": same,
                  "ok": bad == 0 and same})
            check(bad == 0 and same,
                  f"GEMM kernel outside its bound in {bad} elements, or not "
                  f"repeatable, at g={g} b_m={b_m} rounding={rounding}")


# --------------------------------------------------------------------------
# phase 5: flash attention against its plain version
# --------------------------------------------------------------------------

def flash_operands(B, L, H, Kv, D, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, L, H, D), generator=gen, device=DEV) * 0.5
    k = torch.randn((B, L, Kv, D), generator=gen, device=DEV) * 0.5
    v = torch.randn((B, L, Kv, D), generator=gen, device=DEV) * 0.5
    return q, k, v


def phase_flash(ops, ref):
    worst = 0.0
    for i, (B, L, H, Kv, D, window) in enumerate(FLASH_CASES):
        q, k, v = flash_operands(B, L, H, Kv, D, seed=100 + i)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        err = (got - want).abs()
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
        emit({"phase": "flash_vs_plain", "B": B, "L": L, "H": H, "Kv": Kv,
              "D": D, "instance": ops.flash_head_dim(D), "window": window,
              "max_abs_err": float(err.max()), "ok": ok})
        check(ok, f"flash kernel outside rtol=atol=2e-5 at B={B} L={L} "
                  f"H={H} Kv={Kv} D={D} window={window}")
        worst = max(worst, float(err.max()))
    for i, (B, L, H, Kv, D) in enumerate(FLASH_NONCAUSAL):
        q, k, v = flash_operands(B, L, H, Kv, D, seed=150 + i)
        got = ops.flash_attention(q, k, v, causal=False)
        again = ops.flash_attention(q, k, v, causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False)
        err = (got - want).abs()
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
        same = bool(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)))
        emit({"phase": "flash_vs_plain", "B": B, "L": L, "H": H, "Kv": Kv,
              "D": D, "instance": ops.flash_head_dim(D), "window": None,
              "causal": False, "max_abs_err": float(err.max()), "ok": ok,
              "bitwise_repeatable": same})
        check(ok and same, f"non-causal flash kernel outside rtol=atol=2e-5 "
                           f"at B={B} L={L} H={H} Kv={Kv} D={D}, or not "
                           f"repeatable")
        worst = max(worst, float(err.max()))
        del q, k, v, got, again, want, err
    return worst


def start_flash_ptxas():
    """nvcc on csrc/flash_attention.cu alone with ``-Xptxas -v`` (the
    extension's flags), started beside the extension's build: each head-dim
    instance's registers, stack frame and spills."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    cmd = [str(nvcc), *build.CUDA_FLAGS, "-cubin", "-Xptxas=-v", "-o",
           str(build.BUILD_DIR / "flash_attention.cubin"),
           str(build.CSRC / "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def phase_flash_ptxas(proc):
    import re
    out, _ = proc.communicate(timeout=600)
    per_d, d = {}, None
    for line in out.splitlines():
        m = re.search(r"flash_fwd_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            d = int(m.group(1))
            per_d[d] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and d is not None:
            per_d[d].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and d is not None:
            per_d[d]["registers"] = int(m.group(1))
    ok = proc.returncode == 0 and sorted(per_d) == [16, 32, 64, 80, 96, 128]
    emit({"phase": "flash_ptxas", "returncode": proc.returncode,
          "instances": {str(k): v for k, v in sorted(per_d.items())},
          "ok": ok})
    check(ok, f"nvcc -Xptxas -v on flash_attention.cu failed or missed an "
              f"instance: {out[-2000:]}")
    return per_d


# --------------------------------------------------------------------------
# phases 5b-5e: the residue kernels against their plain versions, and the
# RNS GEMM against the BFP GEMM
# --------------------------------------------------------------------------

def random_residues(moduli, shape, gen):
    """int32 residues in [0, m) per modulus, stacked on a leading axis."""
    return torch.stack([torch.randint(0, m, shape, generator=gen, device=DEV,
                                      dtype=torch.int32) for m in moduli])


def rns_cases():
    """(moduli, M, K, N) of every slice GEMM on the RNS paths (the head
    only at decode: prefill runs the head on the last positions alone)."""
    for moduli in (RNS_BASE, RRNS_ALL):
        for M in RNS_M:
            for K, N in GEMM_KN:
                if M > SLOTS and N == 151936:
                    continue
                yield moduli, M, K, N
    yield RNS_K8, SLOTS, 896, 896


def residue_operands(moduli, M, K, N, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    G = K // 16
    return (random_residues(moduli, (G, M, 16), gen),
            random_residues(moduli, (G, 16, N), gen))


def encoded_residue_operands(moduli, M, K, N, seed, b_m: int = 4):
    """Residues of BFP mantissas in [-(2^b_m - 1), 2^b_m - 1], encoded as
    the RNS paths encode them (``to_rns``): each residue GEMM output is then
    one integer group dot (|dot| <= 16 x 15^2 < psi) in every modulus, as
    on the serving path, and a clean decode stops at subset 0."""
    from repro_torch.core.rns import to_rns

    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, G = 2 ** b_m - 1, K // 16
    xi = torch.randint(-q, q + 1, (G, M, 16), generator=gen, device=DEV)
    wi = torch.randint(-q, q + 1, (G, 16, N), generator=gen, device=DEV)
    return to_rns(xi, moduli), to_rns(wi, moduli)


def phase_rns_matmul(ops, ref):
    for i, (moduli, M, K, N) in enumerate(rns_cases()):
        t0 = time.perf_counter()
        xr, wr = residue_operands(moduli, M, K, N, seed=200 + i)
        got = ops.rns_group_matmul(xr, wr, moduli)
        want = ref.rns_matmul_ref(xr, wr, moduli)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        emit({"phase": "rns_matmul_vs_plain", "moduli": list(moduli),
              "M": M, "K": K, "N": N, "mismatches": bad, "ok": bad == 0,
              "seconds": time.perf_counter() - t0})
        check(bad == 0, f"rns_matmul differs from its plain version in "
                        f"{bad} residues at moduli={moduli} M={M} K={K} "
                        f"N={N}")
    return 0


def detector_noise(moduli, shape, snr_db, gen):
    from repro_torch.analog.channel import detector_sigma_levels
    sig = torch.tensor([detector_sigma_levels(m, snr_db) for m in moduli],
                       device=DEV).reshape(-1, 1, 1, 1)
    return torch.randn((len(moduli),) + tuple(shape), generator=gen,
                       device=DEV) * sig


def phase_rns_channel(ops, ref):
    """The fused readout at 20 dB (sigma 2-4 levels: every rounding and
    wrap case occurs) and at the slice's 52 dB."""
    (_, _), (_, _), ffn, down, head = GEMM_KN
    cases = [(SLOTS,) + ffn, (SLOTS,) + down, (SLOTS,) + head,
             (RNS_M[-1],) + ffn]
    for i, (M, K, N) in enumerate(cases):
        xr, wr = residue_operands(RRNS_ALL, M, K, N, seed=300 + i)
        G = K // 16
        gen = torch.Generator(device=DEV).manual_seed(400 + i)
        for snr in (20.0, SNR_DB):
            noise = detector_noise(RRNS_ALL, (G, M, N), snr, gen)
            for adc_bits in (None, 4, 5):
                t0 = time.perf_counter()
                got, flips = ops.rns_group_matmul_channel(
                    xr, wr, RRNS_ALL, noise, adc_bits, count_flips=True)
                want, want_flips = ref.rns_matmul_channel_ref(
                    xr, wr, RRNS_ALL, noise, adc_bits, count_flips=True)
                torch.cuda.synchronize()
                bad = int((got != want).sum())
                flips_ok = flips.tolist() == want_flips.tolist()
                emit({"phase": "rns_matmul_channel_vs_plain", "M": M,
                      "K": K, "N": N, "snr_db": snr, "adc_bits": adc_bits,
                      "mismatches": bad, "flips": flips.tolist(),
                      "flips_equal_plain": flips_ok,
                      "ok": bad == 0 and flips_ok,
                      "seconds": time.perf_counter() - t0})
                check(bad == 0, f"rns_matmul_channel differs from its plain "
                                f"version in {bad} residues at M={M} K={K} "
                                f"N={N} snr={snr} adc_bits={adc_bits}")
                check(flips_ok, f"the readout kernel counted {flips.tolist()}"
                                f" moved residues, its plain version "
                                f"{want_flips.tolist()}, at M={M} K={K} "
                                f"N={N} snr={snr} adc_bits={adc_bits}")
    return 0


def decode_inputs(E, seed):
    """Residues of legal values with 0, 1 or 2 residue errors at known
    places (by element index mod 3), then E // 2 random tuples."""
    psi = (math.prod(RNS_BASE) - 1) // 2
    gen = torch.Generator(device=DEV).manual_seed(seed)
    xs = torch.randint(-psi, psi + 1, (E,), generator=gen, device=DEV,
                       dtype=torch.int32)
    xs[:6] = torch.tensor([psi, -psi, 0, psi - 1, 1 - psi, 1], device=DEV)
    n_err = torch.arange(E, device=DEV) % 3
    n = len(RRNS_ALL)
    i1 = torch.randint(0, n, (E,), generator=gen, device=DEV)
    i2 = (i1 + torch.randint(1, n, (E,), generator=gen, device=DEV)) % n
    rows = []
    for i, m in enumerate(RRNS_ALL):
        hit = ((n_err >= 1) & (i1 == i)) | ((n_err == 2) & (i2 == i))
        delta = torch.randint(1, m, (E,), generator=gen, device=DEV,
                              dtype=torch.int32)
        rows.append(torch.remainder(xs + torch.where(hit, delta, 0), m))
    res = torch.stack(rows).to(torch.int32)
    rand = random_residues(RRNS_ALL, (E // 2,), gen)
    return torch.cat([res, rand], dim=1).contiguous(), xs, n_err


def subset0_fault_inputs(tables, E, seed):
    """Legal values where about half the elements, at random places (so
    warps mix clean and faulty elements), carry one or two residue errors
    on the moduli of subset 0: those elements never reach the largest vote
    (two errors leave at most three agreeing moduli, and 31 x 32 x 33 is
    more than the legal range) and run every subset."""
    psi = tables.psi
    gen = torch.Generator(device=DEV).manual_seed(seed)
    xs = torch.randint(-psi, psi + 1, (E,), generator=gen, device=DEV,
                       dtype=torch.int32)
    faulty = torch.rand((E,), generator=gen, device=DEV) < 0.5
    two = torch.rand((E,), generator=gen, device=DEV) < 0.5
    members = tables.subsets[0]
    first = torch.randint(0, len(members), (E,), generator=gen, device=DEV)
    second = (first + 1) % len(members)
    rows = []
    for i, m in enumerate(tables.moduli):
        hit = torch.zeros((E,), dtype=torch.bool, device=DEV)
        if i in members:
            j = members.index(i)
            hit = faulty & ((first == j) | (two & (second == j)))
        delta = torch.randint(1, m, (E,), generator=gen, device=DEV,
                              dtype=torch.int32)
        rows.append(torch.remainder(xs + torch.where(hit, delta, 0), m))
    n_err = faulty.to(torch.int32) * (1 + two.to(torch.int32))
    return torch.stack(rows).to(torch.int32).contiguous(), xs, n_err


def phase_rrns_decode(ops, ref):
    from repro_torch.analog import rrns
    from repro_torch.core.noise import rrns_decode_np

    psi = (math.prod(RNS_BASE) - 1) // 2
    tables = rrns.get_tables(RRNS_ALL, len(RNS_BASE), psi)
    t0 = time.perf_counter()
    res, xs, n_err = decode_inputs(4_000_000, seed=500)
    E = xs.shape[0]
    dec, votes = ops.rrns_decode(res, tables)
    want_dec, want_votes = ref.rrns_decode_ref(res, tables)
    torch.cuda.synchronize()
    bad_dec = int((dec != want_dec).sum())
    bad_votes = int((votes.view(torch.int32) !=
                     want_votes.view(torch.int32)).sum())
    legal_dec = dec[:E]
    clean_ok = bool(((legal_dec == xs) & (votes[:E] == 10.0))[n_err == 0]
                    .all())
    single_ok = bool(((legal_dec == xs) & (votes[:E] == 4.0))[n_err == 1]
                     .all())
    sample = torch.randperm(res.shape[1], device=DEV)[:10_000]
    o_dec, _ = rrns_decode_np(res[:, sample].cpu().numpy(), RRNS_ALL,
                              len(RNS_BASE), psi)
    bad_oracle = int((dec[sample].cpu().numpy() != o_dec).sum())
    ok = bad_dec == bad_votes == bad_oracle == 0 and clean_ok and single_ok
    emit({"phase": "rrns_decode_vs_plain", "elements": int(res.shape[1]),
          "decoded_mismatches": bad_dec, "votes_mismatches": bad_votes,
          "oracle_sample": 10_000, "oracle_mismatches": bad_oracle,
          "clean_decoded_exactly": clean_ok,
          "single_errors_corrected": single_ok, "ok": ok,
          "seconds": time.perf_counter() - t0})
    check(ok, "rrns_decode differs from its plain version or the numpy "
              "oracle, or failed to decode a clean or single-error value")
    # errors on subset 0's moduli, scattered through every warp; an odd
    # element count takes the kernel's scalar loads and its tail
    for E in (4_000_000, 1_000_003):
        t0 = time.perf_counter()
        res, xs, n_err = subset0_fault_inputs(tables, E, seed=E % 97)
        dec, votes = ops.rrns_decode(res, tables)
        want_dec, want_votes = ref.rrns_decode_ref(res, tables)
        torch.cuda.synchronize()
        bad_dec = int((dec != want_dec).sum())
        bad_votes = int((votes.view(torch.int32) !=
                         want_votes.view(torch.int32)).sum())
        full = votes == float(tables.n_subsets)
        ok = bad_dec == bad_votes == 0 and \
            bool(torch.equal(full, n_err == 0)) and \
            bool((dec == xs)[n_err <= 1].all())
        emit({"phase": "rrns_decode_vs_plain",
              "case": "errors on subset 0's moduli, mixed warps",
              "elements": E, "faulty_elements": int((n_err > 0).sum()),
              "decoded_mismatches": bad_dec, "votes_mismatches": bad_votes,
              "ok": ok, "seconds": time.perf_counter() - t0})
        check(ok, f"rrns_decode differs from its plain version, or failed "
                  f"to decode, on {E} elements with errors on subset 0's "
                  f"moduli")
    return 0


def phase_rns_equals_fast(ops, ref):
    """mirage_rns (residue kernel + CRT), clean mirage_rrns (residue kernel
    + decode kernel) and mirage_fast (BFP GEMM kernel) compute the same
    exact integer group dots, so they differ only in the order of the f32
    sums: held to the gemm_vs_plain bound."""
    from repro_torch.core import gemm
    from repro_torch.core.precision import get_policy

    fast = get_policy("mirage")
    worst = 0.0
    for M in RNS_M:
        for K, N in GEMM_KN:
            if M > SLOTS and N == 151936:
                continue
            t0 = time.perf_counter()
            x, w = gemm_operands(M, K, N, seed=M * 5 + K + N)
            out = {mode: gemm.mirage_matmul_nograd(x, w, get_policy(mode))
                   for mode in ("mirage_rns", "mirage_rrns")}
            out["mirage_fast"] = gemm.mirage_matmul_nograd(x, w, fast)
            xq, wq = folded(ref, x, w, fast)
            tol = 1e-5 * (xq.abs() @ wq.abs()) + 1e-30
            errs = {}
            for a, b in (("mirage_rns", "mirage_fast"),
                         ("mirage_rrns", "mirage_fast"),
                         ("mirage_rrns", "mirage_rns")):
                d = (out[a] - out[b]).abs()
                errs[f"{a}-{b}"] = (float(d.max()), int((d > tol).sum()))
            torch.cuda.synchronize()
            bad = sum(n for _, n in errs.values())
            emit({"phase": "rns_equals_fast", "M": M, "K": K, "N": N,
                  "max_abs_err": {k: v[0] for k, v in errs.items()},
                  "over_tol": {k: v[1] for k, v in errs.items()},
                  "ok": bad == 0, "seconds": time.perf_counter() - t0})
            check(bad == 0, f"mirage_rns / mirage_rrns / mirage_fast differ "
                            f"beyond 1e-5 (|xq|@|wq|) at M={M} K={K} N={N}")
            worst = max(worst, max(v[0] for v in errs.values()))
    return worst


# --------------------------------------------------------------------------
# phase 6: the slice — full-width qwen2-0.5b served on the card
# --------------------------------------------------------------------------

def make_requests(Request, vocab: int, max_tokens: Optional[int] = None):
    max_tokens = MAX_TOKENS if max_tokens is None else max_tokens
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)
                                               ).astype(np.int32),
                    max_tokens=max_tokens) for i, n in enumerate(lens)]


def phase_slice(ops):
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions
    from repro_torch.runtime.server import LMServer, Request

    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, get_policy("mirage"),
                        LMCallOptions(use_flash_kernel=True), device=DEV,
                        generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    cap = CAP

    # warm-up drain (cuBLAS handles, allocator); not counted
    warm = LMServer(model, cap=cap, batch_slots=SLOTS)
    for r in make_requests(Request, cfg.vocab_size)[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm

    t_prog = time.perf_counter()
    server = LMServer(model, cap=cap, batch_slots=SLOTS)
    reqs = make_requests(Request, cfg.vocab_size)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t_prog
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    for r in reqs:
        server.submit(r)
    finished = server.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)
    cold_drain("dense", server, finished, dt, launches, program_s)

    m = server.metrics
    batches, steps = m["prefill_batches"], m["decode_steps"]
    n_tok = sum(len(r.tokens_out) for r in finished)
    lat = server.scheduler.latency_summary()
    lens_ok = all(len(r.tokens_out) == MAX_TOKENS for r in finished)
    vocab_ok = all(0 <= t < cfg.vocab_size for r in finished
                   for t in r.tokens_out)
    per_step = 7 * cfg.n_layers + 1   # q k v o gate up down per layer + head
    want_gemm = per_step * (batches + steps)
    want_flash = cfg.n_layers * batches
    emit({"phase": "slice", "arch": cfg.arch_id, "params": n_params,
          "d_model": cfg.d_model, "n_layers": cfg.n_layers,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)", "slots": SLOTS,
          "requests": len(finished), "tokens": n_tok,
          "prompt_lens": [len(r.prompt) for r in reqs],
          "prefill_batches": batches, "decode_steps": steps,
          "launches": launches, "gemm_per_step": per_step,
          "expected_mirage_gemm": want_gemm,
          "expected_flash_attention": want_flash,
          "seconds": dt, "tok_per_s": n_tok / dt,
          "ttft_mean_ms": lat["ttft_mean_s"] * 1e3,
          "ttft_p50_ms": lat["ttft_p50_s"] * 1e3,
          "ttft_p99_ms": lat["ttft_p99_s"] * 1e3,
          "tpot_mean_ms": lat["tpot_mean_s"] * 1e3,
          "tpot_p50_ms": lat["tpot_p50_s"] * 1e3,
          "tpot_p99_ms": lat["tpot_p99_s"] * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "build_model_s": t_run - t0})
    check(len(finished) == N_REQUESTS and lens_ok,
          "not every request completed with max_tokens tokens")
    check(vocab_ok, "a served token lies outside the vocabulary")
    check(launches["mirage_gemm"] == want_gemm,
          f"mirage_gemm launched {launches['mirage_gemm']} times, expected "
          f"{per_step} x (prefill batches + decode steps) = {want_gemm}")
    check(launches["flash_attention"] == want_flash,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"expected n_layers x prefill batches = {want_flash}")

    profile_ticks(model, cap, reqs, LMServer, "mirage_fast")
    compare_with_cpu(model, reqs[0].prompt, cap)
    streams = {r.rid: r.tokens_out for r in finished}
    return launches, batches, steps, model, cap, streams


#: the host ops that draw random numbers (their time includes their
#: kernels' launches)
RNG_HOST_OPS = ("aten::randn", "aten::rand", "aten::randint",
                "aten::exponential_")


def device_profile(run, n: int, host: bool = True):
    """Device time by kernel over ``n`` calls of ``run`` (torch.profiler),
    per call, and the device's idle share of their wall time. Only the
    device's own events count: a host op's self device time is the time of
    the kernels it launched, which appear as events of their own, so
    summing both would count every kernel twice. ``host=False`` records
    the device's events alone (no graph launches are then seen), which
    costs a step of ~46,000 kernels far less to record and sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if host else []) +
                 [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, launches, graph_launches = {}, 0, 0
    for avg in prof.key_averages():
        dev_us = getattr(avg, "self_device_time_total", 0.0)
        if avg.device_type == DeviceType.CUDA and dev_us > 0:
            by_kernel[avg.key] = by_kernel.get(avg.key, 0.0) + dev_us
            launches += avg.count
        elif avg.key == "cudaGraphLaunch":
            graph_launches += avg.count
    busy_ms = sum(by_kernel.values()) / 1e3
    # the random draws: torch's RNG kernels on the device, and the host
    # time of the ops that launch them (inclusive of their launches)
    rng_dev_us = sum(v for k, v in by_kernel.items() if "distribution_" in k)
    rng_host_us = sum(avg.cpu_time_total for avg in prof.key_averages()
                      if avg.device_type == DeviceType.CPU and
                      avg.key in RNG_HOST_OPS)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    ours = {k[:80]: v / 1e3 / n for k, v in by_kernel.items()
            if any(name in k for name in PORT_KERNEL_SYMBOLS)}
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy_ms / n,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top_device_ms": {k[:80]: v / 1e3 / n for k, v in top},
            "port_kernels_ms": ours, "device_kernels": launches / n,
            "graph_launches": graph_launches / n,
            "rng_device_ms": rng_dev_us / 1e3 / n,
            "rng_host_ms": rng_host_us / 1e3 / n}


def profile_ticks(model, cap, reqs, LMServer, policy_name: str,
                  n_ticks: int = 2, **engine_kw):
    """Device time by kernel over a few steady decode ticks (torch.profiler)
    and the device's idle share of their wall time."""
    prof = engine_tick_profile(
        LMServer(model, cap=cap, batch_slots=SLOTS, **engine_kw), reqs,
        n_ticks)
    emit({"phase": "decode_tick_profile", "policy": policy_name,
          "ticks": n_ticks,
          "wall_ms_per_tick": prof["wall_ms"],
          "device_busy_ms_per_tick": prof["device_busy_ms"],
          "device_idle_share": prof["device_idle_share"],
          "device_kernels_per_tick": prof["device_kernels"],
          "top_device_ms_per_tick": prof["top_device_ms"],
          "port_kernels_ms_per_tick": prof["port_kernels_ms"]})


def steady_requests(server, reqs, n_ticks: int) -> None:
    """Admit ``SLOTS`` of ``reqs``, cut to outlast ``n_ticks`` steady ticks
    after the admission tick, and run that tick."""
    for r in reqs[:SLOTS]:
        server.submit(dataclasses.replace(r, tokens_out=[],
                                          max_tokens=n_ticks + 3))
    server.tick()


def engine_tick_profile(server, reqs, n_ticks: int = 3):
    """:func:`device_profile` of ``n_ticks`` steady ticks of ``server``;
    the requests are drained after."""
    steady_requests(server, reqs, n_ticks)
    prof = device_profile(server.tick, n_ticks)
    server.run_until_drained()
    return prof


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


def host_cpu_flags() -> str:
    """The host CPU's vector extensions (the CPU's plain versions sum in the
    order its math library picks for them)."""
    try:
        flags = pathlib.Path("/proc/cpuinfo").read_text().split("flags")[1]
    except (OSError, IndexError):
        return "unknown"
    return " ".join(f for f in ("avx2", "avx512f", "avx512_bf16", "amx_tile")
                    if f" {f}" in flags.splitlines()[0])


def compare_with_cpu(model, prompt_np, cap):
    """Hold the card's path against the same weights on the CPU, where every
    kernel is its plain version.

    Under mirage the random-weight full-width model is chaotic: one f32
    summation-order difference moves a value across a BFP rounding boundary,
    a step of up to 1/16 of its group's max, and the move grows through 24
    layers. So the gated mirage check is per layer, teacher-forced (each
    layer gets the card's input on both sides), with the end-to-end mirage
    error printed beside it; the end-to-end check runs under fp32, where
    nothing amplifies order differences."""
    from repro_torch.core.precision import get_policy
    from repro_torch.models import common

    cpu_model = copy.deepcopy(model).to("cpu")
    prompt = torch.from_numpy(prompt_np[None].astype(np.int64))
    L = prompt.shape[1]
    t0 = time.perf_counter()
    with torch.inference_mode():
        pos_d, pos_h = torch.arange(L, device=DEV), torch.arange(L)
        h = common.embed(model.embed, prompt.to(DEV))
        layer_err = []
        # digests of each side's layer outputs: when a run's errors move, they
        # tell whether the card's bits or the host's changed
        digest_d, digest_h = hashlib.sha1(), hashlib.sha1()
        for layer_d, layer_h in zip(model.layers, cpu_model.layers):
            out_d, _, _ = model._attn_mlp_block(layer_d, h, pos_d)
            out_h, _, _ = cpu_model._attn_mlp_block(layer_h, h.cpu(), pos_h)
            layer_err.append(rel_l2(out_d.cpu(), out_h))
            digest_d.update(out_d.cpu().numpy().tobytes())
            digest_h.update(out_h.numpy().tobytes())
            h = out_d
        head_err = rel_l2(model._head(h[:, -1:]).cpu(),
                          cpu_model._head(h[:, -1:].cpu()))
        ends = {}
        for name in ("mirage", "fp32"):
            model.policy = cpu_model.policy = get_policy(name)
            card, _ = model.prefill(prompt.to(DEV), cap)
            plain, _ = cpu_model.prefill(prompt, cap)
            card = card[0, -1].cpu()
            plain = plain[0, -1]
            ends[name] = (rel_l2(card, plain),
                          int(card.argmax()) == int(plain.argmax()))
        model.policy = get_policy("mirage")
    ok = max(layer_err) < 1e-2 and head_err < 1e-2 and \
        ends["fp32"][0] < 1e-4 and ends["fp32"][1]
    emit({"phase": "slice_vs_cpu_plain", "prompt_len": L,
          "mirage_layer_rel_l2_max": max(layer_err),
          "mirage_layers_differing": sum(e > 0 for e in layer_err),
          "mirage_layer_rel_l2": layer_err,
          "card_layers_sha1": digest_d.hexdigest(),
          "cpu_layers_sha1": digest_h.hexdigest(),
          "host_cpu_flags": host_cpu_flags(),
          "host_threads": torch.get_num_threads(),
          "aten_cpu_capability": torch.backends.cpu.get_cpu_capability(),
          "mkl": torch.backends.mkl.is_available(),
          "pinned_env": {k: os.environ.get(k) for k in (
              "ATEN_CPU_CAPABILITY", "MKL_CBWR")},
          "mirage_head_rel_l2": head_err,
          "mirage_end_to_end_rel_l2": ends["mirage"][0],
          "mirage_end_to_end_top1_match": ends["mirage"][1],
          "fp32_end_to_end_rel_l2": ends["fp32"][0],
          "fp32_end_to_end_top1_match": ends["fp32"][1],
          "cpu_seconds": time.perf_counter() - t0, "ok": ok})
    check(ok, "card vs CPU: a mirage layer or the head differs by >= 1e-2 "
              "relative L2 (teacher-forced), or the fp32 end-to-end logits "
              "by >= 1e-4 or in their top-1")


# --------------------------------------------------------------------------
# phases 6b-6d: the RNS serving paths at full width
# --------------------------------------------------------------------------

class DecodedElements:
    """Counts the elements every RRNS decode of a run covers (the expected
    detector flips scale with them) by wrapping ``ops.rrns_decode``; the
    wrapped function and its launch count are unchanged."""

    def __init__(self, ops):
        self.ops, self.elements = ops, 0

    def __enter__(self):
        self.inner = self.ops.rrns_decode

        def counted(residues, tables):
            self.elements += residues[0].numel()
            return self.inner(residues, tables)

        self.ops.rrns_decode = counted
        return self

    def __exit__(self, *exc):
        self.ops.rrns_decode = self.inner


def serve_run(ops, model, cap, reqs, LMServer, prepare=None, **engine_kw):
    """Program a fresh engine (with ``engine_kw``), call ``prepare`` on it
    (a warmup, say), reset the counts, drain ``reqs``; return the engine,
    the finished requests, the seconds and the launches."""
    t0 = time.perf_counter()
    server = LMServer(model, cap=cap, batch_slots=SLOTS, **engine_kw)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    if prepare is not None:
        prepare(server)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    for r in reqs:
        server.submit(r)
    finished = server.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_run
    return server, finished, dt, dict(ops.LAUNCHES), program_s


#: the cold drains of engines that serve_warmup holds its warmed engines
#: against, kept by the phases that drained them first (the same engine
#: options, model and requests): name -> (summary, streams, health)
COLD_DRAINS = {}


def cold_drain(name, server, finished, dt, launches, program_s) -> None:
    COLD_DRAINS[name] = (
        {**serve_summary(server, finished, dt, launches, program_s),
         "model_steps": model_steps(server.metrics)},
        {r.rid: r.tokens_out for r in finished}, server.health_snapshot())


def serve_summary(server, finished, dt, launches, program_s):
    lat = server.scheduler.latency_summary()
    n_tok = sum(len(r.tokens_out) for r in finished)
    m = server.metrics
    return {"requests": len(finished), "tokens": n_tok,
            "prefill_batches": m["prefill_batches"],
            "decode_steps": m["decode_steps"], "launches": launches,
            "seconds": dt, "tok_per_s": n_tok / dt,
            "ttft_mean_ms": lat["ttft_mean_s"] * 1e3,
            "ttft_p50_ms": lat["ttft_p50_s"] * 1e3,
            "ttft_p99_ms": lat["ttft_p99_s"] * 1e3,
            "tpot_mean_ms": lat["tpot_mean_s"] * 1e3,
            "tpot_p50_ms": lat["tpot_p50_s"] * 1e3,
            "tpot_p99_ms": lat["tpot_p99_s"] * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "program_weights_s": program_s}


def expect_launches(launches, want, path):
    for name, n in launches.items():
        check(n == want.get(name, 0),
              f"{path}: {name} launched {n} times, expected "
              f"{want.get(name, 0)}")


def phase_slice_rrns(ops, model, cap):
    """mirage_rrns at 52 dB, stationary weights: the fused-readout kernel
    and the decode kernel on every GEMM, every error corrected, and the
    same greedy streams as the clean channel."""
    from repro_torch.analog.channel import detector_sigma_levels
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    noisy = get_policy("mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)
    model.policy = noisy
    warm = LMServer(model, cap=cap, batch_slots=SLOTS)   # not counted
    for r in make_requests(Request, cfg.vocab_size)[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm
    reqs = make_requests(Request, cfg.vocab_size)
    with DecodedElements(ops) as decoded:
        server, finished, dt, launches, program_s = serve_run(
            ops, model, cap, reqs, LMServer)
    summary = serve_summary(server, finished, dt, launches, program_s)
    health = server.health_snapshot()
    stationary_gb = sum(m.stationary.residues.numel() * 4
                        for m in model.modules()
                        if getattr(m, "stationary", None) is not None) / 1e9
    batches, steps = summary["prefill_batches"], summary["decode_steps"]
    per_step = 7 * cfg.n_layers + 1
    want = {"rns_matmul_channel": per_step * (batches + steps),
            "rrns_decode": per_step * (batches + steps),
            "flash_attention": cfg.n_layers * batches}
    # P(flip) = P(|n| >= 1/2) for n ~ N(0, sigma_m^2): round(n) is then a
    # nonzero multiple of m only with negligible probability
    p_flip = [math.erfc(0.5 / (detector_sigma_levels(m, SNR_DB) *
                               math.sqrt(2))) for m in RRNS_ALL]
    expected = [decoded.elements * p for p in p_flip]
    flips41 = health["detector_flips"][-1]
    flips_ok = abs(flips41 - expected[-1]) <= 6 * math.sqrt(expected[-1])

    clean_policy = get_policy("mirage_rrns", noise_seed=NOISE_SEED)
    model.policy = clean_policy
    clean_reqs = make_requests(Request, cfg.vocab_size)
    c_server, c_finished, c_dt, c_launches, c_prog = serve_run(
        ops, model, cap, clean_reqs, LMServer)
    c_summary = serve_summary(c_server, c_finished, c_dt, c_launches, c_prog)
    c_steps = c_summary["prefill_batches"] + c_summary["decode_steps"]
    c_want = {"rns_matmul": per_step * c_steps,
              "rrns_decode": per_step * c_steps,
              "flash_attention": cfg.n_layers * c_summary["prefill_batches"]}
    streams = {r.rid: r.tokens_out for r in finished}
    c_streams = {r.rid: r.tokens_out for r in c_finished}
    health_same = all(health.get(k) == v for k, v in RRNS_HEALTH.items())
    emit({"phase": "slice_rrns", "arch": cfg.arch_id,
          "policy": f"mirage_rrns b_m=4 g=16 k=5 moduli={list(RRNS_ALL)} "
                    f"snr_db={SNR_DB} noise_seed={NOISE_SEED}",
          "slots": SLOTS, "stationary_weights": server.stationary_weights,
          "stationary_residues_gb": stationary_gb, **summary, "expected_launches": want, "health": health,
          "decoded_elements": decoded.elements,
          "p_flip_per_modulus": p_flip,
          "expected_detector_flips": expected,
          "flips_41_within_6_sigma": flips_ok,
          "clean_channel": {**c_summary, "expected_launches": c_want,
                            "health": c_server.health_snapshot()},
          "health_equals_reference": health_same,
          "streams_equal_clean": streams == c_streams})
    check(len(finished) == N_REQUESTS and all(
        len(r.tokens_out) == MAX_TOKENS for r in finished),
        "mirage_rrns: not every request completed with max_tokens tokens")
    expect_launches(launches, want, "mirage_rrns at 52 dB")
    expect_launches(c_launches, c_want, "mirage_rrns, clean channel")
    check(health["rrns_uncorrected"] == 0,
          f"{health['rrns_uncorrected']} decodes beyond the correction "
          f"radius at {SNR_DB} dB")
    check(health["rrns_corrected"] > 0, "no RRNS correction at 52 dB")
    check(flips_ok, f"detector flips of modulus 41: {flips41}, expected "
                    f"{expected[-1]:.1f} +- 6 sigma")
    check(streams == c_streams, "the 52 dB greedy streams differ from the "
                                "clean channel's")
    check(health_same, f"slice_rrns health counters "
                       f"{ {k: health.get(k) for k in RRNS_HEALTH} } differ "
                       f"from the reference run's {RRNS_HEALTH}")
    # the 52 dB tick's profile, cold and warmed: serve_warmup, whose cold
    # side is this drain
    cold = ({**summary, "model_steps": batches + steps}, streams, health)
    return launches, c_launches, streams, cold


class ReadoutAudit:
    """Wraps the RRNS path's on-card readout (``mirage_rrns
    ._readout_on_card``) to hold each noisy readout's residues against the
    clean residue GEMM's and against the draw rule, round(n) % m != 0
    (what the flip counter counted before the kernel counted its own moved
    residues). Where the f32 sum res + n is exactly a half-integer the
    kernel rounds half to even, so whether the residue moves depends on its
    parity: such ties are listed."""

    def __init__(self, ops):
        from repro_torch.core.backends import mirage_rrns
        self.ops, self.module = ops, mirage_rrns
        self.sums, self.elements_moved, self.ties = {}, 0, []

    def __enter__(self):
        self.inner = inner = self.module._readout_on_card

        def audited(xr, wr, moduli, cfg, noise):
            out = inner(xr, wr, moduli, cfg, noise)
            self.add(xr, wr, moduli, noise, out)
            return out

        self.module._readout_on_card = audited
        return self

    def add(self, xr, wr, moduli, noise, out):
        clean = self.ops.rns_group_matmul(xr, wr, moduli)
        self.ops.LAUNCHES["rns_matmul"] -= 1       # not the path's launch
        shape = (-1, 1, 1, 1)
        mods = torch.tensor(moduli, dtype=torch.float32,
                            device=DEV).reshape(shape)
        drawn = torch.remainder(torch.round(noise), mods) != 0
        moved = out != clean
        for key, mask in (("drawn", drawn), ("moved", moved)):
            n = mask.sum(dim=(1, 2, 3)).tolist()
            self.sums[key] = [a + b for a, b in zip(
                self.sums.get(key, [0] * len(n)), n)]
        self.elements_moved += int((moved.sum(0) > 0).sum())
        for i in (drawn != moved).nonzero()[:8].tolist():
            i = tuple(i)
            self.ties.append({"modulus": moduli[i[0]],
                              "residue": int(clean[i]),
                              "noise": float(noise[i]),
                              "residue_plus_noise": float(clean[i] + noise[i]),
                              "out": int(out[i])})

    def __exit__(self, *exc):
        self.module._readout_on_card = self.inner


def audit_rrns_health(ops):
    """``--audit-rrns-health``: the slice_rrns drain alone (same model,
    requests, warm-up and noise seed), each noisy readout audited; prints
    the health counters beside the audit. RRNS_HEALTH's rrns_corrected
    counts the elements whose residues moved, so it follows the residues'
    parity at the ties, hence every upstream kernel's f32 rounding."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions
    from repro_torch.runtime.server import LMServer, Request

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg, get_policy("mirage"),
                        LMCallOptions(use_flash_kernel=True), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(0))
    model.policy = get_policy("mirage_rrns", snr_db=SNR_DB,
                              noise_seed=NOISE_SEED)
    warm = LMServer(model, cap=CAP, batch_slots=SLOTS)
    for r in make_requests(Request, cfg.vocab_size)[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm
    with ReadoutAudit(ops) as audit:
        server = serve_run(ops, model, CAP, make_requests(
            Request, cfg.vocab_size), LMServer)[0]
    emit({"phase": "rrns_health_audit", "health": server.health_snapshot(),
          "reference": RRNS_HEALTH, "residues": audit.sums,
          "elements_moved": audit.elements_moved, "ties": audit.ties})
    return 0


def phase_slice_rns(ops, model, cap):
    """A shorter mirage_rns drain: the residue kernel on every GEMM."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    model.policy = get_policy("mirage_rns")
    reqs = make_requests(Request, cfg.vocab_size,
                         max_tokens=RNS_TOKENS)[:RNS_REQUESTS]
    server, finished, dt, launches, program_s = serve_run(
        ops, model, cap, reqs, LMServer)
    summary = serve_summary(server, finished, dt, launches, program_s)
    steps = summary["prefill_batches"] + summary["decode_steps"]
    want = {"rns_matmul": (7 * cfg.n_layers + 1) * steps,
            "flash_attention": cfg.n_layers * summary["prefill_batches"]}
    emit({"phase": "slice_rns", "arch": cfg.arch_id,
          "policy": "mirage_rns b_m=4 g=16 k=5", "slots": SLOTS, **summary,
          "expected_launches": want})
    check(len(finished) == RNS_REQUESTS and all(
        len(r.tokens_out) == RNS_TOKENS for r in finished),
        "mirage_rns: not every request completed with its tokens")
    expect_launches(launches, want, "mirage_rns")
    return launches


# --------------------------------------------------------------------------
# phases 6e-6g: slice 5, the paged serving engine at full width
# --------------------------------------------------------------------------

PAGED_BS = 4                  # CAP = 164 = 41 x 4: the gathered span is the
#                               dense ring's, so the streams must be equal
SMALL_POOL = dict(block_size=16, n_blocks=22)   # half of 4 slots x 11 blocks
SHARED_PREFIX, TAIL_LENS = 64, (17, 64)
SPEC_K, PREFILL_CHUNK = 3, 32
TOP2_GAP = 1e-4               # fp32: a differing token needs a near-tie
#: serve_paged_options' depth: 4 of qwen2-0.5b's 24 layers (the script's
#: time limit; its five engines' drains are host-bound)
OPTIONS_LAYERS = 4
OPTION_ENGINES = (
    ("dense", {}),
    ("paged_chunk", dict(cache_layout="paged", block_size=PAGED_BS,
                         prefill_chunk=PREFILL_CHUNK)),
    ("paged_prefix", dict(cache_layout="paged", block_size=PAGED_BS,
                          prefix_cache=True)),
    ("paged_spec", dict(cache_layout="paged", block_size=PAGED_BS,
                        spec_k=SPEC_K)),
    ("paged_all", dict(cache_layout="paged", block_size=PAGED_BS,
                       prefill_chunk=PREFILL_CHUNK, prefix_cache=True,
                       spec_k=SPEC_K)),
)


def model_steps(metrics) -> int:
    """Passes of the whole model an engine ran, from its own counters:
    bucketed prefill batches, prefill chunks, decode ticks and verify
    ticks each run every GEMM once."""
    return (metrics["prefill_batches"] + metrics["prefill_chunks"] +
            metrics["decode_steps"] + metrics["spec_ticks"])


def pool_summary(server):
    """The paged pool after a drain: its geometry, peak use and bytes; the
    allocator's invariants must hold and every block must be back."""
    from repro_torch.models.lm import pool_keys

    a = server.alloc
    a.check_invariants()
    cache = server.state["cache"]
    return {"block_size": a.block_size, "n_blocks": a.n_blocks,
            "peak_in_use": a.peak_in_use, "in_use_after_drain": a.used_count,
            "pool_gb": sum(cache[k].numel() * cache[k].element_size()
                           for k in pool_keys(cache)) / 1e9}


def dense_cache_gb(model, cap) -> float:
    spec = model.cache_spec(SLOTS, cap, per_slot_idx=True)
    return sum(math.prod(shape) * 4 for k, (shape, _) in spec.items()
               if k in ("k", "v")) / 1e9


def token_share(streams, ref) -> float:
    """Share of ``ref``'s tokens that ``streams`` has at the same place."""
    total = sum(len(t) for t in ref.values())
    same = sum(a == b for rid, toks in ref.items()
               for a, b in zip(streams.get(rid, []), toks))
    return same / total if total else 0.0


def tick_ms(model, cap, reqs, n_ticks: int, **engine_kw) -> float:
    """:func:`engine_tick_ms` of a fresh engine built with ``engine_kw``."""
    from repro_torch.runtime.server import LMServer

    return engine_tick_ms(LMServer(model, cap=cap, batch_slots=SLOTS,
                                   **engine_kw), reqs, n_ticks)


@contextlib.contextmanager
def eager(server, on: bool = True):
    """``server`` ticking eagerly while open (``on``): its captured graphs
    set aside, then put back."""
    graphs = dict(server._graphs) if on else {}
    if on:
        server._graphs.clear()
    try:
        yield server
    finally:
        server._graphs.update(graphs)


def engine_tick_ms(server, reqs, n_ticks: int) -> float:
    """Host wall time of one steady tick of ``server`` (the mean of
    ``n_ticks``, after the admission tick), to a synchronize; the
    requests are drained after, so one engine serves every run."""
    steady_requests(server, reqs, n_ticks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        server.tick()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    server.run_until_drained()
    return ms


def phase_slice_paged(ops, model, cap, dense_streams):
    """The slice's requests through the paged engine: at block size 4 the
    dense engine's streams and launches; at block size 16 on half the
    default pool, admissions queue for blocks (not gated on equality: the
    gathered span, 176, is not the ring's 164)."""
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    per_step = 7 * cfg.n_layers + 1
    dense_gb = dense_cache_gb(model, cap)
    rows, first = {}, None
    for name, kw in (("block_size_4", dict(block_size=PAGED_BS)),
                     ("block_size_16_half_pool", SMALL_POOL)):
        reqs = make_requests(Request, cfg.vocab_size)
        server, finished, dt, launches, program_s = serve_run(
            ops, model, cap, reqs, LMServer, cache_layout="paged", **kw)
        streams = {r.rid: r.tokens_out for r in finished}
        m = server.metrics
        want = {"mirage_gemm": per_step * model_steps(m),
                "flash_attention": cfg.n_layers * m["prefill_batches"]}
        rows[name] = {**serve_summary(server, finished, dt, launches,
                                      program_s),
                      **pool_summary(server), "dense_cache_gb": dense_gb,
                      "expected_launches": want,
                      "tokens_equal_dense": token_share(streams,
                                                        dense_streams),
                      "streams_equal_dense": streams == dense_streams}
        check(len(finished) == N_REQUESTS and all(
            len(r.tokens_out) == MAX_TOKENS for r in finished),
            f"slice_paged {name}: not every request completed")
        check(server.alloc.used_count == 0,
              f"slice_paged {name}: blocks still in use after the drain")
        expect_launches(launches, want, f"slice_paged {name}")
        if first is None:
            first = launches
            cold_drain("paged", server, finished, dt, launches, program_s)
            check(streams == dense_streams, "slice_paged: the block-size-4 "
                  "streams differ from the dense engine's")
    # the steady tick of both layouts in turns (dense, paged, paged, dense,
    # ...), host clock to a synchronize: the host sets the tick's time, and
    # it varies by a third within one call, so 8 runs of 10 ticks each
    reqs = make_requests(Request, cfg.vocab_size)
    ticks = {"dense": [], "paged": []}
    for order in (("dense", "paged"), ("paged", "dense")) * 4:
        for name in order:
            kw = {} if name == "dense" else dict(cache_layout="paged",
                                                 block_size=PAGED_BS)
            ticks[name].append(tick_ms(model, cap, reqs, 10, **kw))
    med = {k: statistics.median(v) for k, v in ticks.items()}
    emit({"phase": "slice_paged", "policy": "mirage (mirage_fast b_m=4 "
          "g=16 k=5)", "slots": SLOTS, "cap": cap, **rows,
          "tick_ms": ticks, "tick_ms_median": med,
          "paged_over_dense_tick": med["paged"] / med["dense"]})
    profile_ticks(model, cap, reqs, LMServer, "mirage_fast paged",
                  cache_layout="paged", block_size=PAGED_BS)
    return first


def phase_slice_rrns_paged(ops, model, cap, rrns_streams):
    """mirage_rrns at 52 dB through the paged engine (block size 4): the
    same GEMMs at the same shapes draw the same noise from the same two
    streams, so the dense drain's streams and health integers."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    model.policy = get_policy("mirage_rrns", snr_db=SNR_DB,
                              noise_seed=NOISE_SEED)
    reqs = make_requests(Request, cfg.vocab_size)
    server, finished, dt, launches, program_s = serve_run(
        ops, model, cap, reqs, LMServer, cache_layout="paged",
        block_size=PAGED_BS)
    summary = serve_summary(server, finished, dt, launches, program_s)
    health = server.health_snapshot()
    per_step = 7 * cfg.n_layers + 1
    steps = model_steps(server.metrics)
    want = {"rns_matmul_channel": per_step * steps,
            "rrns_decode": per_step * steps,
            "flash_attention": cfg.n_layers * summary["prefill_batches"]}
    streams = {r.rid: r.tokens_out for r in finished}
    health_same = all(health.get(k) == v for k, v in RRNS_HEALTH.items())
    emit({"phase": "slice_rrns_paged", "policy": f"mirage_rrns "
          f"snr_db={SNR_DB} noise_seed={NOISE_SEED}", "slots": SLOTS,
          "stationary_weights": server.stationary_weights, **summary,
          **pool_summary(server), "expected_launches": want,
          "health": health, "health_equals_reference": health_same,
          "streams_equal_dense": streams == rrns_streams})
    expect_launches(launches, want, "slice_rrns_paged")
    check(streams == rrns_streams, "slice_rrns_paged: the streams differ "
                                   "from the dense 52 dB drain's")
    check(health_same, f"slice_rrns_paged health counters "
                       f"{ {k: health.get(k) for k in RRNS_HEALTH} } differ "
                       f"from the reference run's {RRNS_HEALTH}")
    check(server.alloc.used_count == 0,
          "slice_rrns_paged: blocks still in use after the drain")
    return launches


def shared_prefix_requests(Request, vocab: int):
    """8 requests sharing a 64-token prefix, each with a tail of 17-64
    tokens (numpy seed 1), MAX_TOKENS each."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    tails = rng.integers(TAIL_LENS[0], TAIL_LENS[1] + 1, N_REQUESTS)
    return [Request(rid=i, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, int(n)).astype(np.int32)]),
        max_tokens=MAX_TOKENS) for i, n in enumerate(tails)]


def dense_top2_gap(model, prompt, tokens) -> float:
    """The gap between the two largest logits after ``prompt + tokens``,
    from one forward pass of the model."""
    ctx = np.concatenate([prompt, np.asarray(tokens, np.int32)])
    with torch.inference_mode():
        logits = model(torch.from_numpy(ctx[None].astype(np.int64)
                                        ).to(DEV))[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def serve_streams(server, reqs):
    """Drain ``reqs`` through ``server``; the streams by request id."""
    for r in reqs:
        server.submit(r)
    return {r.rid: r.tokens_out for r in server.run_until_drained()}


def first_differences(model, dense, streams, prompts):
    """Where each stream first differs from the dense engine's, with the
    dense logits' top-2 gap there (one forward pass of ``model``)."""
    firsts = []
    for rid, toks in dense.items():
        j = next((i for i, (a, b) in enumerate(zip(streams[rid], toks))
                  if a != b), None)
        if j is not None:
            firsts.append({"rid": rid, "position": j,
                           "dense_top2_gap": dense_top2_gap(
                               model, prompts[rid], toks[:j])})
    return firsts


def phase_serve_paged_options(ops, cap):
    """qwen2-0.5b at its widths cut to OPTIONS_LAYERS layers: 8 requests
    sharing a 64-token prefix through the dense engine and four paged ones
    (chunked prefill, prefix cache, speculative decoding, all three). fp32:
    the streams equal the dense engine's, or first differ where the dense
    logits' top-2 gap is under TOP2_GAP. mirage: speed, the share of
    tokens equal to dense, the prefix and speculative counters, and GEMM
    launches = 7 x layers + 1 x the engine's model steps."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

    model = published_model("qwen2-0.5b", OPTIONS_LAYERS,
                            get_policy("mirage"))
    cfg = model.cfg
    per_step = 7 * cfg.n_layers + 1
    out, total = {}, {}
    for policy in ("fp32", "mirage"):
        model.policy = get_policy(policy)
        runs = {}
        for name, kw in OPTION_ENGINES:
            reqs = shared_prefix_requests(Request, cfg.vocab_size)
            server, finished, dt, launches, program_s = serve_run(
                ops, model, cap, reqs, LMServer, **kw)
            m = server.metrics
            row = serve_summary(server, finished, dt, launches, program_s)
            row.update({k: m[k] for k in (
                "prefill_chunks", "prefix_hits", "prefix_full_hits",
                "prefix_shared_blocks", "cow_forks", "spec_ticks",
                "spec_accepted", "spec_slot_ticks")})
            row["model_steps"] = model_steps(m)
            if server.alloc is not None:
                row.update(pool_summary(server))
                check(server.alloc.used_count == 0,
                      f"{policy} {name}: blocks still in use after the "
                      f"drain")
            check(len(finished) == N_REQUESTS and all(
                len(r.tokens_out) == MAX_TOKENS for r in finished),
                f"serve_paged_options {policy} {name}: not every request "
                f"completed")
            if policy == "mirage":
                want = {"mirage_gemm": per_step * row["model_steps"],
                        "flash_attention": cfg.n_layers * m["prefill_batches"]}
                row["expected_launches"] = want
                expect_launches(launches, want,
                                f"serve_paged_options mirage {name}")
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            runs[name] = ({r.rid: r.tokens_out for r in finished},
                          {r.rid: r.prompt for r in finished}, row)
        dense, prompts, _ = runs["dense"]
        for name, (streams, _, row) in runs.items():
            row["tokens_equal_dense"] = token_share(streams, dense)
            row["streams_equal_dense"] = streams == dense
            if policy != "fp32" or name == "dense":
                continue
            firsts = first_differences(model, dense, streams, prompts)
            row["first_differences"] = firsts
            check(all(f["dense_top2_gap"] < TOP2_GAP for f in firsts),
                  f"serve_paged_options fp32 {name}: a stream differs from "
                  f"the dense engine's where the top-2 gap is >= "
                  f"{TOP2_GAP}: {firsts}")
        out[policy] = {name: row for name, (_, _, row) in runs.items()}
    del model
    free_card()
    emit({"phase": "serve_paged_options", "n_layers": cfg.n_layers,
          "slots": SLOTS, "cap": cap,
          "block_size": PAGED_BS, "prefill_chunk": PREFILL_CHUNK,
          "spec_k": SPEC_K, "shared_prefix": SHARED_PREFIX,
          "tail_lens": list(TAIL_LENS), **out})
    return total


# --------------------------------------------------------------------------
# phases 6h-6k: the rest of slice 5 (warmup and the tick's CUDA graph,
# pipelined prefill, elastic resize, backend switch) at full width
# --------------------------------------------------------------------------

WARM_ENGINES = (
    ("dense", "mirage", {}),
    ("paged", "mirage", dict(cache_layout="paged", block_size=PAGED_BS)),
    ("paged_spec", "mirage", dict(cache_layout="paged", block_size=PAGED_BS,
                                  spec_k=SPEC_K)),
    ("rrns_52db", "mirage_rrns", {}),
)
#: (runs a side, ticks a run) of the cold-against-warmed tick timing (the
#: dense engine's 2 runs a side from PR 28, for the script's time limit)
WARM_TICK_RUNS = {"dense": (2, 10), "rrns_52db": (1, 4)}
PIPELINE_DEPTH = 2


def serve_policy(name: str):
    from repro_torch.core.precision import get_policy
    if name == "mirage_rrns":
        return get_policy(name, snr_db=SNR_DB, noise_seed=NOISE_SEED)
    return get_policy(name)


def warmed(info: dict):
    """A ``serve_run`` hook: warm the engine up, recording its stats, the
    memory the capture took and its compile counts."""
    def prepare(server):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()    # as the capture does: reserved = pool
        alloc0 = torch.cuda.memory_allocated()
        res0 = torch.cuda.memory_reserved()
        info.update(server.warmup())
        torch.cuda.synchronize()
        info["allocated_gb"] = (torch.cuda.memory_allocated() - alloc0) / 1e9
        info["reserved_gb"] = (torch.cuda.memory_reserved() - res0) / 1e9
        info["compile_counts_before"] = server.compile_counts()
    return prepare


def phase_serve_warmup(ops, model, cap, cold_runs=None):
    """Warmed engines against cold ones, token for token: mirage_fast on
    the dense engine, the paged engine at block size 4, paged with spec_k =
    3, and mirage_rrns at 52 dB (its health counters RRNS_HEALTH; its cold
    drain is slice_rrns's, the dense and paged ones slice's and
    slice_paged's: the same engines on the same requests, passed in
    ``cold_runs`` as (summary, streams, health) by engine name). A
    warmed engine replays its tick as one CUDA graph: its launch counts
    must equal the cold drain's, its compile counts must hold across the
    drain, and its profile must show one graph launch a tick. Then the
    steady tick, cold against warmed in turns, and each one's device busy
    time and idle share."""
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    out, launches_warm = {}, {}
    for name, policy, kw in WARM_ENGINES:
        model.policy = serve_policy(policy)
        rows, streams, healths, warm = {}, {}, {}, None
        for side in ("cold", "warmed"):
            if side == "cold" and name in (cold_runs or {}):
                rows[side], streams[side], healths[side] = cold_runs[name]
                continue
            info = {}
            reqs = make_requests(Request, cfg.vocab_size)
            server, finished, dt, launches, program_s = serve_run(
                ops, model, cap, reqs, LMServer,
                prepare=warmed(info) if side == "warmed" else None, **kw)
            rows[side] = {**serve_summary(server, finished, dt, launches,
                                          program_s),
                          "model_steps": model_steps(server.metrics)}
            streams[side] = {r.rid: r.tokens_out for r in finished}
            healths[side] = server.health_snapshot()
            check(len(finished) == N_REQUESTS and all(
                len(r.tokens_out) == MAX_TOKENS for r in finished),
                f"serve_warmup {name} {side}: not every request completed")
            if side == "warmed":
                warm = server
                info["compile_counts_after"] = server.compile_counts()
                rows[side]["warmup"] = info
                launches_warm[name] = launches
                check(info["graphs"] == 1 and len(server._graphs) == 1,
                      f"serve_warmup {name}: no tick graph was captured")
                check(info["compile_counts_after"] ==
                      info["compile_counts_before"],
                      f"serve_warmup {name}: compile counts moved during a "
                      f"warmed drain: {info}")
        check(streams["warmed"] == streams["cold"],
              f"serve_warmup {name}: the warmed streams differ from the "
              f"cold engine's")
        check(rows["warmed"]["launches"] == rows["cold"]["launches"],
              f"serve_warmup {name}: warmed launches "
              f"{rows['warmed']['launches']} differ from cold "
              f"{rows['cold']['launches']}")
        row = {"policy": policy, "engine": kw, **rows,
               "streams_equal": streams["warmed"] == streams["cold"]}
        if policy == "mirage_rrns":
            row["health"] = healths
            for side, h in healths.items():
                check(all(h.get(k) == v for k, v in RRNS_HEALTH.items()),
                      f"serve_warmup {name} {side}: health "
                      f"{ {k: h.get(k) for k in RRNS_HEALTH} } differs from "
                      f"the reference run's {RRNS_HEALTH}")
        reqs = make_requests(Request, cfg.vocab_size)
        if name in WARM_TICK_RUNS:
            # the warmed drain's engine, ticked with its captured graph
            # ("warmed") and with it set aside ("cold": the eager step of
            # an engine before warmup()); one engine, so no second one
            # programs and warms the same weights again (for the
            # script's time limit)
            runs, n_ticks = WARM_TICK_RUNS[name]
            ticks = {"cold": [], "warmed": []}
            for order in (("cold", "warmed"), ("warmed", "cold")) * \
                    (runs // 2) + ((("cold", "warmed"),) if runs % 2
                                   else ()):
                for side in order:
                    with eager(warm, side == "cold"):
                        ticks[side].append(engine_tick_ms(warm, reqs,
                                                          n_ticks))
            med = {k: statistics.median(v) for k, v in ticks.items()}
            row.update({"tick_ms": ticks, "tick_ms_median": med,
                        "warmed_over_cold_tick": med["warmed"] /
                        med["cold"], "ticks_per_run": n_ticks})
            row["profile"] = {}
            for side in ("cold", "warmed"):
                with eager(warm, side == "cold"):
                    prof = engine_tick_profile(warm, reqs, 2)
                row["profile"][side] = {
                    k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                         "device_idle_share",
                                         "device_kernels", "graph_launches",
                                         "top_device_ms")}
            check(row["profile"]["warmed"]["graph_launches"] == 1,
                  f"serve_warmup {name}: the warmed tick's profile shows "
                  f"{row['profile']['warmed']['graph_launches']} graph "
                  f"launches a tick, expected 1")
        del warm, server
        out[name] = row
    emit({"phase": "serve_warmup", "slots": SLOTS, "cap": cap,
          "block_size": PAGED_BS, "spec_k": SPEC_K, **out,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches_warm


def stream_ids(trace: dict):
    """Stream ids of a chrome trace's kernels, by kernel name, and of its
    device-to-host copies (the decode thread's payloads)."""
    kernels, d2h = {}, set()
    for ev in trace.get("traceEvents", []):
        stream = (ev.get("args") or {}).get("stream")
        if stream is None:
            continue
        if ev.get("cat") == "kernel":
            kernels.setdefault(ev["name"][:60], set()).add(stream)
        elif ev.get("cat") == "gpu_memcpy" and "DtoH" in ev.get("name", ""):
            d2h.add(stream)
    return kernels, d2h


def phase_serve_pipelined(ops, model, cap, dense_streams):
    """pipeline_depth = 2 against the synchronous engine under mirage_fast,
    cold and warmed (the tick a graph replay): equal streams and launches;
    TTFT, TPOT and tok/s of each; then a profiled pipelined drain shows
    the prefill's flash kernels on a stream other than the decode stream
    (the one the payloads reach the host from)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    model.policy = serve_policy("mirage")
    per_step = 7 * cfg.n_layers + 1
    rows = {}
    for name, kw in (("sync", {}),
                     ("pipelined", dict(pipeline_depth=PIPELINE_DEPTH)),
                     ("sync_warmed", {}),
                     ("pipelined_warmed",
                      dict(pipeline_depth=PIPELINE_DEPTH))):
        reqs = make_requests(Request, cfg.vocab_size)
        server, finished, dt, launches, program_s = serve_run(
            ops, model, cap, reqs, LMServer,
            prepare=(lambda srv: srv.warmup()) if "warmed" in name
            else None, **kw)
        server.close()
        streams = {r.rid: r.tokens_out for r in finished}
        m = server.metrics
        want = {"mirage_gemm": per_step * model_steps(m),
                "flash_attention": cfg.n_layers * m["prefill_batches"]}
        rows[name] = {**serve_summary(server, finished, dt, launches,
                                      program_s),
                      "expected_launches": want,
                      "streams_equal_dense": streams == dense_streams}
        check(len(finished) == N_REQUESTS and all(
            len(r.tokens_out) == MAX_TOKENS for r in finished),
            f"serve_pipelined {name}: not every request completed")
        expect_launches(launches, want, f"serve_pipelined {name}")
        check(streams == dense_streams, f"serve_pipelined {name}: the "
                                        f"streams differ from slice's")
        if name == "pipelined":
            pipe_launches = launches
    server = LMServer(model, cap=cap, batch_slots=SLOTS,
                      pipeline_depth=PIPELINE_DEPTH)
    trace_path = pathlib.Path(__file__).resolve().parent / "build" / \
        "serve_pipelined_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for r in make_requests(Request, cfg.vocab_size,
                                   max_tokens=8):
                server.submit(r)
            server.run_until_drained()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace_path))
    finally:
        server.close()
    kernels, d2h = stream_ids(json.loads(trace_path.read_text()))
    trace_path.unlink()
    flash = set()
    for k, v in kernels.items():
        if "flash_fwd" in k:
            flash |= v
    emit({"phase": "serve_pipelined", "policy": "mirage (mirage_fast b_m=4 "
          "g=16 k=5)", "slots": SLOTS, "pipeline_depth": PIPELINE_DEPTH,
          **rows, "pipelined_over_sync_tok_s":
          rows["pipelined"]["tok_per_s"] / rows["sync"]["tok_per_s"],
          "warmed_pipelined_over_sync_tok_s":
          rows["pipelined_warmed"]["tok_per_s"] /
          rows["sync_warmed"]["tok_per_s"],
          "flash_streams": sorted(flash), "decode_streams": sorted(d2h),
          "kernel_streams": {k: sorted(v) for k, v in kernels.items()},
          "phase_seconds": time.perf_counter() - t_phase})
    check(bool(flash) and bool(d2h) and not flash & d2h,
          f"serve_pipelined: the prefill's flash kernels ran on streams "
          f"{sorted(flash)}, the decode payloads on {sorted(d2h)}: they "
          f"must differ")
    return pipe_launches


def phase_serve_resize(ops, model, cap):
    """A paged drain (block size 4) that grows from 2 to 4 slots after two
    ticks, then shrinks its block pool to one block above the live ones and
    grows it back, against a fixed 4-slot engine fed the same arrivals
    (the first two requests, two ticks, then the rest: every prefill runs
    at the same shapes in both, so the f32 orders and streams are equal)."""
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    model.policy = serve_policy("mirage")
    kw = dict(cache_layout="paged", block_size=PAGED_BS)
    runs = {}
    for name in ("fixed", "resized"):
        reqs = make_requests(Request, cfg.vocab_size)
        server = LMServer(model, cap=cap,
                          batch_slots=2 if name == "resized" else SLOTS, **kw)
        t0 = time.perf_counter()
        for r in reqs[:2]:
            server.submit(r)
        server.tick()
        server.tick()
        moves = {}
        if name == "resized":
            server.resize_slots(SLOTS)
            moves["live_blocks"] = server.alloc.used_count
            moves["pool_before"] = server.alloc.n_blocks
            server.resize_block_pool(server.alloc.used_count + 1)
            server.alloc.check_invariants()
            moves["pool_shrunk_to"] = server.alloc.n_blocks
            # back to the fixed engine's pool, so admissions wait for
            # blocks in neither
            server.resize_block_pool(SLOTS *
                                     server.alloc.max_blocks_per_slot)
            server.alloc.check_invariants()
        for r in reqs[2:]:
            server.submit(r)
        finished = server.run_until_drained()
        torch.cuda.synchronize()
        server.alloc.check_invariants()
        runs[name] = ({r.rid: r.tokens_out for r in finished}, {
            "requests": len(finished), "seconds": time.perf_counter() - t0,
            "slots": server.n_slots, **moves, **pool_summary(server)})
        check(len(finished) == N_REQUESTS and all(
            len(r.tokens_out) == MAX_TOKENS for r in finished),
            f"serve_resize {name}: not every request completed")
    equal = runs["resized"][0] == runs["fixed"][0]
    emit({"phase": "serve_resize", "policy": "mirage (mirage_fast b_m=4 "
          "g=16 k=5)", "block_size": PAGED_BS,
          **{k: v[1] for k, v in runs.items()},
          "tokens_equal_fixed": token_share(runs["resized"][0],
                                            runs["fixed"][0]),
          "streams_equal_fixed": equal,
          "phase_seconds": time.perf_counter() - t_phase})
    check(equal, "serve_resize: the resized engine's streams differ from "
                 "the fixed 4-slot engine's")


SWITCH_AFTER_TICKS = 8


def phase_serve_switch(ops, model, cap, dense_streams):
    """mirage_rrns at 52 dB switches to mirage after 8 ticks: every request
    drains with its budget, and the card's allocated memory drops by the
    stationary residues. Then mirage switches to mirage after 8 ticks: the
    streams of slice's drain, which never switched."""
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    rows = {}
    for name, before, after in (("rrns_to_mirage", "mirage_rrns", "mirage"),
                                ("mirage_to_mirage", "mirage", "mirage")):
        model.policy = serve_policy(before)
        server = LMServer(model, cap=cap, batch_slots=SLOTS)
        encoded = [m.stationary for m in model.modules()
                   if getattr(m, "stationary", None) is not None]
        residue_gb = sum(e.residues.numel() * e.residues.element_size()
                         for e in encoded) / 1e9
        scale_gb = sum(e.scale.numel() * e.scale.element_size()
                       for e in encoded) / 1e9
        del encoded
        reqs = make_requests(Request, cfg.vocab_size)
        t0 = time.perf_counter()
        for r in reqs:
            server.submit(r)
        finished = []
        for _ in range(SWITCH_AFTER_TICKS):
            finished.extend(server.tick())
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        server.switch_backend(serve_policy(after))
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        finished.extend(server.run_until_drained())
        torch.cuda.synchronize()
        streams = {r.rid: r.tokens_out for r in finished}
        rows[name] = {"seconds": time.perf_counter() - t0,
                      "requests": len(finished),
                      "stationary_residues_gb": residue_gb,
                      "stationary_scales_gb": scale_gb,
                      "allocated_before_switch_gb": mem_before / 1e9,
                      "allocated_after_switch_gb": mem_after / 1e9,
                      "freed_gb": (mem_before - mem_after) / 1e9,
                      "health_after": server.health_snapshot(),
                      "streams_equal_slice": streams == dense_streams}
        check(len(finished) == N_REQUESTS and all(
            len(r.tokens_out) == MAX_TOKENS for r in finished),
            f"serve_switch {name}: not every request drained with its "
            f"budget")
        if before == "mirage_rrns":
            check(residue_gb > 7 and mem_before - mem_after >=
                  residue_gb * 1e9,
                  f"serve_switch: switching away from mirage_rrns freed "
                  f"{(mem_before - mem_after) / 1e9:.3f} GB, less than the "
                  f"{residue_gb:.3f} GB of stationary residues")
        else:
            check(streams == dense_streams, "serve_switch: a mirage -> "
                  "mirage switch changed the streams")
        del server
    emit({"phase": "serve_switch", "switch_after_ticks": SWITCH_AFTER_TICKS,
          "from_policy": f"mirage_rrns snr_db={SNR_DB} "
                         f"noise_seed={NOISE_SEED}", **rows,
          "phase_seconds": time.perf_counter() - t_phase})


def phase_slice_rrns_vs_cpu(model, cap, prompt_np, layers=(0,)):
    """Teacher-forced card-vs-CPU check of clean mirage_rrns at full width:
    each listed layer and the head get the card's input on both sides."""
    from repro_torch.core import stationary
    from repro_torch.core.precision import get_policy
    from repro_torch.models import common

    model.policy = get_policy("mirage_rrns")
    stationary.install(model, None)     # both sides encode per call
    cpu_model = copy.deepcopy(model).to("cpu")
    prompt = torch.from_numpy(prompt_np[None, :16].astype(np.int64))
    L = prompt.shape[1]
    t0 = time.perf_counter()
    errs = {}
    with torch.inference_mode():
        pos_d, pos_h = torch.arange(L, device=DEV), torch.arange(L)
        h = common.embed(model.embed, prompt.to(DEV))
        for li, layer_d in enumerate(model.layers):
            out_d, _, _ = model._attn_mlp_block(layer_d, h, pos_d)
            if li in layers:
                out_h, _, _ = cpu_model._attn_mlp_block(
                    cpu_model.layers[li], h.cpu(), pos_h)
                errs[f"layer_{li}"] = rel_l2(out_d.cpu(), out_h)
            h = out_d
        errs["head"] = rel_l2(model._head(h[:, -1:]).cpu(),
                              cpu_model._head(h[:, -1:].cpu()))
    ok = max(errs.values()) < 1e-2
    emit({"phase": "slice_rrns_vs_cpu_plain", "policy": "mirage_rrns clean",
          "prompt_len": L, "rel_l2": errs, "cpu_seconds":
          time.perf_counter() - t0, "ok": ok})
    check(ok, "card vs CPU under clean mirage_rrns: a layer or the head "
              "differs by >= 1e-2 relative L2 (teacher-forced)")


# --------------------------------------------------------------------------
# slice 7: fault-managed serving (the chaos schedule, the SNR guardian,
# deadlines and admission caps, snapshots, the metrics exporter) over
# kernels 3, 4 and 6 at full width
# --------------------------------------------------------------------------

#: the guardian's middle rung, r = 4: the base moduli and the first four
#: primes above 2^5 + 1 (default_redundant_moduli(5, 4)); 35 subsets of 3
RRNS_R4 = (31, 32, 33, 37, 41, 43, 47)
#: the chaos drains: 4 requests of 16 prompt tokens, 8 tokens each; the
#: engines a phase warms take the one prompt bucket they use
CHAOS_REQUESTS, CHAOS_PROMPT, CHAOS_TOKENS = 4, 16, 8
CHAOS_CAP = CHAOS_PROMPT + CHAOS_TOKENS + 4
CHAOS_ENGINE = dict(cap=CHAOS_CAP, batch_slots=SLOTS,
                    buckets=(CHAOS_PROMPT,))
COLLAPSE = "snr_drop@0:100000:scale=1e6"    # -120 dB from tick 0
TRANSIENT = "snr_drop@0:4:scale=1e6"        # a four-tick hole
GUARDIAN_WINDOW = 2
#: faults inside r = 2's correction radius on the clean channel: a storm
#: of width-1 bursts, then a stuck redundant channel (modulus 41). At 52 dB
#: each decode tick's ~1.2e8 decoded elements would add ~10 double errors
#: (a noise flip of modulus 37 beside the stuck 41), beyond the radius
CHANNEL_CHAOS = ("burst_storm@0:3:rate=0.05,width=1;"
                 "stuck_channel@3:100000:channel=4,level=7")
#: the host faults of the paged, pipelined engine: the first prefill job
#: crashes (all four requests: one bucket, four free slots), the pool is
#: squeezed by 4 of its 8 unreserved blocks, and one decode payload (four
#: live slots) is corrupted
HOST_CHAOS = ("worker_crash@0;pool_exhaustion@2:5:blocks=4;"
              "host_corruption@5:6:rate=1.0")
HOST_POOL = dict(cache_layout="paged", block_size=PAGED_BS, n_blocks=32)
#: the n_mod-7 shapes timed (rows 4c and 6c): the decode head and the
#: largest prefill's gate/up
CHAOS_TIMED = ((SLOTS, 896, 151936), (RNS_M[-1], 896, 4864))


def chaos_requests(Request, vocab: int, n: int = CHAOS_REQUESTS):
    rng = np.random.default_rng(27)
    return [Request(rid=i, prompt=rng.integers(0, vocab, CHAOS_PROMPT
                                               ).astype(np.int32),
                    max_tokens=CHAOS_TOKENS) for i in range(n)]


def drain_streams(server, reqs, runner=None):
    """Submit ``reqs``, drain (through ``runner``, a guardian's, say) and
    return every retired request's stream by rid."""
    for r in reqs:
        server.submit(r)
    (runner or server.run_until_drained)()
    torch.cuda.synchronize()
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.scheduler.finished}


def statuses(server):
    out = {}
    for r in server.scheduler.finished:
        out[r.status] = out.get(r.status, 0) + 1
    return out


def phase_chaos_kernels(ops, ref):
    """Kernels 4 and 6 at n_mod 7 (the guardian's r = 4 rung), which no
    earlier card run had: every slice GEMM shape bit for bit against the
    plain versions (kernel 4 on BFP mantissas encoded as the path encodes
    them; kernel 6 on kernel 4's outputs through 52 dB noise, and at the
    decode shapes also on random residue tuples, where every element runs
    all 35 subsets); the decode head and the largest prefill's gate/up
    timed beside their bounds (rows 4c and 6c), kernel 4 beside torch.bmm
    with no mod."""
    from repro_torch.analog import rrns
    from repro_torch.analog.channel import add_noise

    t_phase = time.perf_counter()
    psi = (math.prod(RNS_BASE) - 1) // 2
    tables = rrns.get_tables(RRNS_R4, len(RNS_BASE), psi)
    tables_ok = bool(tables.f32_exact) and tables.n_subsets == 35 and \
        list(tables.binom) == [1, 4, 10, 20, 35]
    check(tables_ok, f"the r = 4 tables are not the expected f32-exact "
                     f"35-subset set: {tables.binom}")
    n = len(RRNS_R4)
    rows = {"rns_matmul": [], "rrns_decode": []}
    for i, (M, (K, N)) in enumerate((M, kn) for M in RNS_M
                                    for kn in GEMM_KN):
        if M > SLOTS and N == 151936:
            continue
        t0 = time.perf_counter()
        G = K // 16
        xr, wr = encoded_residue_operands(RRNS_R4, M, K, N, seed=700 + i)
        got = ops.rns_group_matmul(xr, wr, RRNS_R4)
        bad4 = int((got != ref.rns_matmul_ref(xr, wr, RRNS_R4)).sum())
        gen = torch.Generator(device=DEV).manual_seed(800 + i)
        res = add_noise(got, RRNS_R4, detector_noise(RRNS_R4, (G, M, N),
                                                     SNR_DB, gen))
        inputs = {"path": res}
        if M == SLOTS and N != 151936:
            inputs["random residue tuples"] = random_residues(
                RRNS_R4, (G, M, N), gen)
        bad6 = {}
        for kind, r in inputs.items():
            dec, votes = ops.rrns_decode(r, tables)
            want_dec, want_votes = ref.rrns_decode_ref(r, tables)
            bad6[kind] = int((dec != want_dec).sum()) + int(
                (votes.view(torch.int32) !=
                 want_votes.view(torch.int32)).sum())
        torch.cuda.synchronize()
        ok = bad4 == 0 and not any(bad6.values())
        emit({"phase": "chaos_kernels_vs_plain", "moduli": list(RRNS_R4),
              "M": M, "K": K, "N": N, "rns_matmul_mismatches": bad4,
              "rrns_decode_mismatches": bad6, "ok": ok,
              "seconds": time.perf_counter() - t0})
        check(ok, f"kernel 4 or 6 differs from its plain version at n_mod "
                  f"7, M={M} K={K} N={N}: {bad4}, {bad6}")
        if (M, K, N) in CHAOS_TIMED:
            S = n * G
            shape = {"M": M, "K": K, "N": N, "n_mod": n, "G": G,
                     "path": "slice_7"}
            xf = xr.reshape(S, M, 16).float()
            wf = wr.reshape(S, 16, N).float()
            t_b, by = bound_rate(
                4.0 * (S * M * 16 + S * 16 * N + S * M * N),
                2.0 * S * M * N * 16, INT_OPS_PER_S)
            rows["rns_matmul"].append({
                **shape,
                "ms": time_ms(lambda: ops.rns_group_matmul(xr, wr,
                                                           RRNS_R4)),
                "plain_ms": time_ms(lambda: ref.rns_matmul_ref(
                    xr, wr, RRNS_R4), **PLAIN_TIMING),
                "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
                "library": "torch.bmm (no mod)",
                "bound_ms": t_b, "bound_by": by})
            del xf, wf
            rows["rrns_decode"].append(decode_timing_row(
                ops, ref, res, tables, {**shape, "inputs": "path"}))
        del xr, wr, got, res, inputs
    for name, shapes in rows.items():
        for row in shapes:
            emit({"phase": "timing", "kernel": name, **row})
    emit({"phase": "chaos_kernels", "tables": {
        "moduli": list(RRNS_R4), "subsets": tables.n_subsets,
        "binom": list(tables.binom), "f32_exact": bool(tables.f32_exact)},
        "phase_seconds": time.perf_counter() - t_phase})
    free_card()
    return rows


def phase_chaos_guardian(ops, model):
    """The JAX gate ``_chaos_parity`` (tests/test_resilience.py) on the
    card at full width: under ``snr_drop`` at scale 1e6 from tick 0 the
    guardian (windows of 2 ticks) streams exactly the fp32 engine's
    tokens, its ladder walked r=2 -> r=4 -> fp32; the same collapse
    without it streams something else with uncorrected decodes; a
    four-tick hole escalates and then probes back down. While the fault
    scope is open every GEMM takes kernel 4 and the plain readout, then
    kernel 6, once a residue block, and kernel 5 never."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.faults import FaultInjector, FaultSchedule
    from repro_torch.runtime.resilience import SNRGuardian, _rung_name
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    model.policy = get_policy("fp32")
    fp32 = drain_streams(LMServer(model, cap=CHAOS_CAP, batch_slots=SLOTS),
                         chaos_requests(Request, cfg.vocab_size))
    rows, launches = {}, {}
    for name, spec, cooldown in (("collapse_guarded", COLLAPSE, 10_000),
                                 ("collapse_naked", COLLAPSE, None),
                                 ("transient_guarded", TRANSIENT, 1)):
        model.policy = serve_policy("mirage_rrns")
        inj = FaultInjector(FaultSchedule.parse(spec), seed=0)
        server = LMServer(model, cap=CHAOS_CAP, batch_slots=SLOTS,
                          fault_injector=inj)
        guardian = None if cooldown is None else SNRGuardian(
            server, window=GUARDIAN_WINDOW, cooldown=cooldown)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with BlockTap() as tap:
            streams = drain_streams(
                server, chaos_requests(Request, cfg.vocab_size),
                guardian.run_until_drained if guardian else None)
        dt = time.perf_counter() - t0
        n = dict(ops.LAUNCHES)
        launches[name] = n
        health = server.health_snapshot()
        row = {"schedule": spec, "seconds": dt, "statuses": statuses(server),
               "launches": n, "residue_blocks": tap.blocks,
               "streams_equal_fp32": streams == fp32,
               "health_at_end": health, "chaos_log": inj.log}
        if guardian is not None:
            row.update(level=guardian.level, transitions=guardian.transitions,
                       ladder=[_rung_name(p) for p in guardian.ladder])
        rows[name] = row
        check(row["statuses"] == {"completed": CHAOS_REQUESTS},
              f"chaos_guardian {name}: {row['statuses']}")
        check(n["rns_matmul"] == n["rrns_decode"] == tap.blocks > 0 and
              n["rns_matmul_channel"] == 0 and n["mirage_gemm"] == 0,
              f"chaos_guardian {name}: launches {n} against "
              f"{tap.blocks} residue blocks (kernel 5 must not launch "
              f"under an open fault scope)")
        check(n["flash_attention"] > 0 and
              n["flash_attention"] % cfg.n_layers == 0,
              f"chaos_guardian {name}: flash launched "
              f"{n['flash_attention']} times")
        if name == "collapse_guarded":
            check(streams == fp32, "chaos_guardian: the guardian's streams "
                                   "under the collapse differ from the fp32 "
                                   "engine's")
            check(guardian.level == len(guardian.ladder) - 1 and
                  len(guardian.transitions) >= 2,
                  f"chaos_guardian: the ladder did not walk to fp32: "
                  f"{guardian.transitions}")
        elif name == "collapse_naked":
            check(streams != fp32 and health["rrns_uncorrected"] > 0,
                  "chaos_guardian: the unguarded collapse streamed the "
                  "fp32 tokens or reported no uncorrected decode")
        else:
            check(any("escalate" in t for t in guardian.transitions) and
                  any("probe down" in t for t in guardian.transitions),
                  f"chaos_guardian: the transient hole did not escalate "
                  f"and probe down: {guardian.transitions}")
        del server, guardian
        free_card()
    model.policy = serve_policy("mirage_rrns")
    emit({"phase": "chaos_guardian", "arch": cfg.arch_id, "slots": SLOTS,
          "policy": f"mirage_rrns snr_db={SNR_DB} noise_seed={NOISE_SEED}",
          "window": GUARDIAN_WINDOW, **rows,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def phase_chaos_channel(ops, model):
    """Channel faults inside r = 2's correction radius, on the clean
    channel (the faults alone): every decode corrected, none uncorrected,
    the streams of the same engine without the injector; cold and then
    warmed (``warmup()`` with the injector: the tick replays as a graph
    that reads the device control tensors, rewritten before each tick, and
    draws the bursts from its registered generator), the warmed health
    equal to the cold, which a graph with its controls baked in could not
    give. Then a steady chaos tick of each engine profiled (the stuck
    channel's scope open: the plain readout and the burst draws), beside
    serve_warmup's clean 52 dB tick, cold and warmed, of the same run."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.faults import FaultInjector, FaultSchedule
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    reqs = lambda: chaos_requests(Request, cfg.vocab_size)
    model.policy = get_policy("mirage_rrns", noise_seed=NOISE_SEED)
    twin = drain_streams(LMServer(model, **CHAOS_ENGINE), reqs())
    rows, launches, engines = {}, {}, {}
    for side in ("cold", "warmed"):
        inj = FaultInjector(FaultSchedule.parse(CHANNEL_CHAOS), seed=0)
        server = LMServer(model, fault_injector=inj, **CHAOS_ENGINE)
        info = server.warmup() if side == "warmed" else {}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with BlockTap() as tap:
            streams = drain_streams(server, reqs())
        n = dict(ops.LAUNCHES)
        launches[side] = n
        health = server.health_snapshot()
        rows[side] = {"statuses": statuses(server), "launches": n,
                      "residue_blocks": tap.blocks, "health": health,
                      "graphs": len(server._graphs), "warmup": info,
                      "streams_equal_clean_twin": streams == twin,
                      "chaos_log": inj.log}
        check(rows[side]["statuses"] == {"completed": CHAOS_REQUESTS} and
              streams == twin,
              f"chaos_channel {side}: {rows[side]['statuses']}, streams "
              f"equal to the clean twin's: {streams == twin}")
        check(health["rrns_uncorrected"] == 0 and
              health["rrns_corrected"] > 0,
              f"chaos_channel {side}: health {health}")
        # a replayed tick runs no Python, so the tap sees the warmed
        # drain's eager prefills alone; its launches are held to the cold
        # drain's below
        check(n["rns_matmul"] == n["rrns_decode"] and
              n["rns_matmul_channel"] == 0 and
              (side == "warmed" or n["rns_matmul"] == tap.blocks),
              f"chaos_channel {side}: launches {n}, {tap.blocks} blocks")
        engines[side] = server
    check(rows["warmed"]["graphs"] == 1 and
          rows["warmed"]["health"] == rows["cold"]["health"] and
          rows["warmed"]["launches"] == rows["cold"]["launches"],
          f"chaos_channel: the warmed drain's health or launches differ "
          f"from the cold drain's: {rows['warmed']['health']} vs "
          f"{rows['cold']['health']}")
    # a steady chaos tick of each engine, its stuck channel's scope open
    profile = {}
    for side, server in engines.items():
        prof = engine_tick_profile(server, reqs(), 1)
        profile[side] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "device_kernels", "graph_launches", "top_device_ms")}
    del engines, server
    emit({"phase": "chaos_channel", "schedule": CHANNEL_CHAOS,
          "policy": f"mirage_rrns clean noise_seed={NOISE_SEED}", **rows,
          "tick_profile": profile,
          "phase_seconds": time.perf_counter() - t_phase})
    check(profile["warmed"]["graph_launches"] == 1,
          f"chaos_channel: the warmed chaos tick's profile shows "
          f"{profile['warmed']['graph_launches']} graph launches, expected "
          f"1")
    free_card()
    return launches


def phase_chaos_host(ops, model):
    """The host sites on the paged, pipelined engine at 52 dB: a crashed
    prefill job, a squeezed pool, a corrupted decode payload. Every
    request completes with the streams of the same engine without faults;
    ``retried`` equals what the injector's log says it did (the flipped
    tokens, four live slots, and four requests a crashed job); the
    allocator's invariants hold every tick and the pool ends empty."""
    import re

    from repro_torch.runtime.faults import FaultInjector, FaultSchedule
    from repro_torch.runtime.server import LMServer, Request

    cfg = model.cfg
    t_phase = time.perf_counter()
    model.policy = serve_policy("mirage_rrns")
    kw = dict(cap=CHAOS_CAP, batch_slots=SLOTS,
              pipeline_depth=PIPELINE_DEPTH, max_retries=4, **HOST_POOL)
    clean_srv = LMServer(model, **kw)
    try:
        clean = drain_streams(clean_srv, chaos_requests(Request,
                                                        cfg.vocab_size))
    finally:
        clean_srv.close()
    inj = FaultInjector(FaultSchedule.parse(HOST_CHAOS), seed=0)
    server = LMServer(model, fault_injector=inj, **kw)
    squeezed = []
    ops.reset_launch_counts()
    try:
        for r in chaos_requests(Request, cfg.vocab_size):
            server.submit(r)
        while server.scheduler.waiting or \
                any(s is not None for s in server.slot_req):
            server.tick()
            server.alloc.check_invariants()
            squeezed.append(len(server.alloc.quarantined))
    finally:
        server.close()
    torch.cuda.synchronize()
    n = dict(ops.LAUNCHES)
    streams = {r.rid: list(map(int, r.tokens_out))
               for r in server.scheduler.finished}
    flipped = sum(int(m.group(1)) for line in inj.log
                  for m in [re.search(r"flipped (\d+) token", line)] if m)
    crashes = sum("worker_crash fired" in line for line in inj.log)
    row = {"schedule": HOST_CHAOS, "statuses": statuses(server),
           "retried": server.metrics["retried"], "flipped_tokens": flipped,
           "crashed_jobs": crashes, "quarantine_by_tick": squeezed,
           "streams_equal_clean": streams == clean, "launches": n,
           "pool_in_use_at_end": server.alloc.used_count,
           "chaos_log": inj.log, "health": server.health_snapshot()}
    emit({"phase": "chaos_host", "engine": {k: v for k, v in kw.items()
                                            if k != "cap"},
          **row, "phase_seconds": time.perf_counter() - t_phase})
    check(row["statuses"] == {"completed": CHAOS_REQUESTS} and
          streams == clean, f"chaos_host: {row['statuses']}, streams "
                            f"equal to the clean drain's: {streams == clean}")
    check(crashes == 1 and flipped == SLOTS and
          row["retried"] == flipped + SLOTS * crashes,
          f"chaos_host: retried {row['retried']} against {flipped} flipped "
          f"tokens and {crashes} crashed jobs of {SLOTS} requests")
    check(max(squeezed) == 4 and squeezed[-1] == 0 and
          row["pool_in_use_at_end"] == 0,
          f"chaos_host: quarantine {squeezed}, "
          f"{row['pool_in_use_at_end']} blocks in use at the end")
    free_card()
    return n


def phase_deadlines_and_snapshot(ops, model):
    """Deadlines, the admission cap, a crash-consistent snapshot and the
    metrics exporter at full width under 52 dB: a queue TTL retires two
    waiting requests before admission and a decode TTL aborts one
    mid-flight, freeing its blocks; ``max_queue_depth`` refuses with a
    retry-after hint; a snapshot at tick 3 (through pickle) restored into
    a fresh, warmed engine (the graph keeps its addresses, its generators
    take the snapshot's states) resumes the uninterrupted streams and
    health counters, which count every detector flip the draws made;
    ``MetricsServer`` on 127.0.0.1:0 serves the deadline engine's
    registry."""
    import pickle
    import urllib.request

    from repro_torch.obs.http import MetricsServer
    from repro_torch.runtime.server import (AdmissionRejected, LMServer,
                                            Request)

    cfg = model.cfg
    t_phase = time.perf_counter()
    model.policy = serve_policy("mirage_rrns")
    reqs = lambda n=CHAOS_REQUESTS: chaos_requests(Request, cfg.vocab_size,
                                                   n)
    # deadlines on the paged engine
    server = LMServer(model, cap=CHAOS_CAP, batch_slots=SLOTS, **HOST_POOL)
    batch = reqs(SLOTS + 2)
    for r in batch[SLOTS:]:
        r.queue_ttl_s = 0.0
    for r in batch:
        server.submit(r)
    server.tick()
    owned = int(server.alloc.n_owned[0])
    used0 = server.alloc.used_count
    batch[0].ttl_s = 1e-9
    server.tick()
    freed = used0 - server.alloc.used_count
    server.run_until_drained()
    torch.cuda.synchronize()
    server.alloc.check_invariants()
    deadlines = {"statuses": statuses(server),
                 "timed_out": server.metrics["timed_out"],
                 "errors": sorted({r.error for r in batch if r.error}),
                 "blocks_of_aborted_slot": owned,
                 "blocks_freed_by_abort": freed,
                 "pool_in_use_at_end": server.alloc.used_count}
    check(deadlines["statuses"] == {"completed": SLOTS - 1,
                                    "timed_out": 3} and
          deadlines["timed_out"] == 3 and freed >= owned > 0 and
          server.alloc.used_count == 0,
          f"deadlines: {deadlines}")
    # the exporter over that engine's registry
    http = MetricsServer(port=0, registry=server.scheduler.registry).start()
    try:
        got = {}
        for path in ("/metrics", "/metrics.json", "/trace"):
            with urllib.request.urlopen(http.url + path, timeout=10) as rsp:
                got[path] = rsp.read().decode()
    finally:
        http.stop()
    text = server.scheduler.registry.prometheus_text()
    exporter = {"url": http.url, "bytes": {k: len(v) for k, v in got.items()},
                "metrics_equal_registry": got["/metrics"] == text,
                "timed_out_line": "serve_timed_out_total 3" in
                got["/metrics"].splitlines(),
                "health_gauges": sum(ln.startswith("serve_health_")
                                     for ln in got["/metrics"].splitlines()),
                "json_keys": len(json.loads(got["/metrics.json"])),
                "trace_events": len(json.loads(got["/trace"])["traceEvents"])}
    check(exporter["metrics_equal_registry"] and exporter["timed_out_line"]
          and exporter["health_gauges"] > 0,
          f"metrics exporter: {exporter}")
    del server
    # the admission cap
    capped = LMServer(model, cap=CHAOS_CAP, batch_slots=SLOTS,
                      max_queue_depth=2)
    rejected = []
    for r in reqs():
        try:
            capped.submit(r)
        except AdmissionRejected as e:
            rejected.append(e.retry_after_s)
    capped.drain()
    cap_row = {"rejected": len(rejected), "retry_after_s": rejected,
               "statuses": statuses(capped),
               "rejected_metric": capped.metrics["rejected"]}
    check(len(rejected) == 2 and all(s > 0 for s in rejected) and
          cap_row["statuses"] == {"completed": 2},
          f"admission cap: {cap_row}")
    del capped
    # a snapshot at tick 3, resumed by a fresh warmed engine
    whole = LMServer(model, **CHAOS_ENGINE)
    want = drain_streams(whole, reqs())
    want_health = whole.health_snapshot()
    del whole
    half = LMServer(model, **CHAOS_ENGINE)
    for r in reqs():
        half.submit(r)
    for _ in range(3):
        half.tick()
    t0 = time.perf_counter()
    blob = pickle.dumps(half.snapshot())
    snap_s = time.perf_counter() - t0
    del half
    fresh = LMServer(model, **CHAOS_ENGINE)
    fresh.warmup()
    t0 = time.perf_counter()
    fresh.restore(pickle.loads(blob))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    fresh.run_until_drained()
    torch.cuda.synchronize()
    got_streams = {r.rid: list(map(int, r.tokens_out))
                   for r in fresh.scheduler.finished}
    snap_row = {"snapshot_bytes": len(blob), "snapshot_s": snap_s,
                "restore_s": restore_s, "graphs": len(fresh._graphs),
                "streams_equal_uninterrupted": got_streams == want,
                "health": fresh.health_snapshot(),
                "health_uninterrupted": want_health}
    emit({"phase": "deadlines_and_snapshot", "deadlines": deadlines,
          "exporter": exporter, "admission_cap": cap_row,
          "snapshot": snap_row,
          "phase_seconds": time.perf_counter() - t_phase})
    check(got_streams == want and snap_row["health"] == want_health and
          snap_row["graphs"] == 1,
          f"snapshot: the resumed engine's streams or health differ from "
          f"the uninterrupted drain's: {snap_row}")
    del fresh
    free_card()


# --------------------------------------------------------------------------
# phases 8-12: slice 2, training full-width qwen2-0.5b on the card
# --------------------------------------------------------------------------

#: the JAX launcher's defaults (src/repro/launch/train.py:39-60): batch 4 x
#: sequence 64, AdamW at lr 1e-3, grad clip 1.0, get_policy("mirage")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, WSQ_STEPS = 4, 64, 10, 3
TRAIN_TOKENS = (TRAIN_BATCH * TRAIN_SEQ, 3 * 50)   # 256, and a ragged 150
#: the GEMMs of one layer, in the order the model calls them
LAYER_GEMMS = ("q", "k", "v", "o", "gate", "up", "down")
#: True only in a CPU rehearsal: the training phases take the reduced config
REDUCED = False
#: qwen2-0.5b's fp32 training gate against the CPU at its widths, cut to 4
#: of 24 layers (the script's time limit; the CPU's steps over the full
#: depth were most of the phase)
TRAIN_FP32_LAYERS = 4


def train_setup(policy, arch: str = "qwen2-0.5b",
                n_layers: Optional[int] = None, **tc_kw):
    """The launcher's model (weights from seed 0; ``n_layers`` cuts the
    depth as ``--layers`` does), train config and data."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    cfg = get_config(arch)
    cfg = cfg.reduced() if REDUCED else cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=min(n_layers, cfg.n_layers))
    model = build_model(cfg, policy, LMCallOptions(q_chunk=64, kv_chunk=64),
                        device=DEV, generator=torch.Generator(
                            device=DEV).manual_seed(0))
    tc = TrainConfig(policy=policy, optimizer="adamw", lr=1e-3, **tc_kw)
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))
    return cfg, model, tc, data


def gemm_weights(model) -> int:
    """Weights the GEMMs read per token: every Dense weight and the tied
    head's table."""
    return sum(m.w.numel() for m in model.modules() if hasattr(m, "w")) + \
        model.embed.emb.numel()


def bwd_cases(T: int):
    """(gemm, K, N, quantize_w) of every backward GEMM shape of a training
    step at T tokens: dX = dO @ W^T and dW = X^T @ dO; and, for
    weight-stationary training (never the tied head, whose table is not
    pre-quantized), its forward and dX GEMMs, which take the weight as it
    is."""
    for K, N in GEMM_KN:
        yield "dX", K, N, True
        if N != 151936:
            yield "fwd_as_is", K, N, False
            yield "dX_as_is", K, N, False
        yield "dW", K, N, True


def bwd_operands(gemm_name: str, T: int, K: int, N: int, seed: int):
    """The kernel's operands (a, b) for one training GEMM: the layer weight
    is a contiguous (K, N) matrix, the tied head's an (N, K) table read as
    emb.T; dW hands X^T over as a transposed view. The weight-stationary
    weight is made by the trainer's own ``_prequantize_params``: one
    contiguous (N, K) matrix quantized along K, which the forward reads as
    its transposed (K, N) view and dX reads as it is, a contiguous
    (K' = N, N' = K) operand."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.trainer import _prequantize_params

    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((T, K), generator=gen, device=DEV)
    dout = torch.randn((T, N), generator=gen, device=DEV) * 1e-2
    if N == 151936:
        w = (torch.randn((N, K), generator=gen, device=DEV) * 0.02).T
    else:
        w = torch.randn((K, N), generator=gen, device=DEV) / math.sqrt(K)
    if gemm_name == "dW":
        return x.T, dout
    if gemm_name.endswith("_as_is"):
        wq = _prequantize_params({"mlp.w": w}, get_policy("mirage"),
                                 torch.float32)["mlp.w"].detach()
        check(wq.T.is_contiguous(), "the weight-stationary copy is not a "
                                    "transposed view of an (N, K) matrix")
        return (x, wq) if gemm_name == "fwd_as_is" else (dout, wq.T)
    return dout, w.T


def weight_read(b: torch.Tensor) -> str:
    """How the kernel reads its (K, N) weight operand."""
    return "(K, N) row-major" if b.is_contiguous() else \
        "(N, K) row-major, in place"


def gemm_bound(ref, a, b, quantize_w: bool = True):
    """The GEMM check's bound, 1e-5 (|aq| @ |bq|) + 1e-30: every folded
    product is exact in f32, only the order of the f32 sum differs (per
    expert for a stack)."""
    aq = ref.bfp_fake_quant_ref(a, 4, 16)
    bq = ref.bfp_fake_quant_ref(b.transpose(-1, -2), 4, 16).transpose(
        -1, -2) if quantize_w else b
    return 1e-5 * (aq.abs() @ bq.abs()) + 1e-30


def phase_gemm_bwd(ops, ref, policy):
    """Kernel #1 at every dX and dW shape one training step launches (and
    the weight-stationary forward and dX in the layout the trainer gives
    them), at B x L = 256 and a ragged 150 tokens: the existing GEMM check,
    and a second launch bitwise equal."""
    worst = 0.0
    for T in TRAIN_TOKENS:
        for i, (name, K, N, qw) in enumerate(bwd_cases(T)):
            a, b = bwd_operands(name, T, K, N, seed=700 + i + T)
            got = ops.mirage_matmul_fused(a, b, policy, quantize_w=qw)
            again = ops.mirage_matmul_fused(a, b, policy, quantize_w=qw)
            want = ref.mirage_gemm_ref(a, b, policy.b_m, policy.g,
                                       quantize_w=qw)
            tol = gemm_bound(ref, a, b, qw)
            err = (got - want).abs()
            bad = int((err > tol).sum())
            same = bool(torch.equal(got.view(torch.int32),
                                    again.view(torch.int32)))
            torch.cuda.synchronize()
            M, Kc, Nout = a.shape[0], a.shape[1], b.shape[1]
            plan = card_gemm_plan(ops, M, Kc, Nout, policy.b_m, qw)
            emit({"phase": "gemm_bwd_vs_plain", "gemm": name, "tokens": T,
                  "layer_K": K, "layer_N": N, "M": M, "contraction": Kc,
                  "N": Nout, "weight_as_is": not qw,
                  "weight_read": weight_read(b),
                  "route": "mma_bf16" if plan.mma else "decode_f32",
                  "splits": plan.splits, "max_abs_err": float(err.max()),
                  "max_err_over_tol": float((err / tol).max()),
                  "bitwise_repeatable": same, "ok": bad == 0 and same})
            check(bad == 0, f"{name} GEMM outside its bound in {bad} "
                            f"elements at T={T} K={K} N={N}")
            check(same, f"two launches of the {name} GEMM differ at T={T} "
                        f"K={K} N={N}")
            worst = max(worst, float(err.max()))
            del a, b, got, again, want, tol, err
    return worst


def run_train(model, tc, data, n_steps: int, state=None):
    """``n_steps`` of the trainer's loop (``train_loop`` over
    ``make_train_step``, as ``launch/train.py`` runs them); per step the
    wall time to a device synchronize and the metrics."""
    from repro_torch.runtime.trainer import (init_train_state,
                                             make_train_step, train_loop)

    state = init_train_state(model, tc) if state is None else state
    inner = make_train_step(model, tc)
    times, logs = [], []

    def step(state, batch):
        t0 = time.perf_counter()
        state, metrics = inner(state, batch)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        logs.append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    state, _ = train_loop(model, tc, state, data, n_steps, log_every=0,
                          step_fn=step)
    return state, step, times, logs


def phase_slice_train(ops):
    """The slice: 10 steps of the launcher's training at full width, every
    forward, dX and dW GEMM through kernel #1; then 2 steps profiled."""
    from repro_torch.core.precision import get_policy

    cfg, model, tc, data = train_setup(get_policy("mirage"))
    data = iter(data)
    per_step = 7 * cfg.n_layers + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    state, step, times, logs = run_train(model, tc, data, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    weights = gemm_weights(model)
    flops = 6.0 * weights * tokens
    losses = [m["loss"] for m in logs]
    finite = all(math.isfinite(v) for v in losses)
    want = {"mirage_gemm": 3 * per_step * TRAIN_STEPS}
    emit({"phase": "slice_train", "arch": cfg.arch_id,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "optimizer": "adamw lr=1e-3 clip=1.0",
          "params": sum(p.numel() for p in model.parameters()),
          "gemm_weights": weights, "gemm_per_step": 3 * per_step,
          "launches": launches, "expected_launches": want,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_2_to_10": step_s * 1e3,
          "tok_per_s": tokens / step_s, "peak_mem_gb": peak,
          "allocated_before_gb": before,
          "model_flops_per_step": flops,
          "model_flops_share_of_989_tflops": flops / step_s / BF16_FLOPS_PER_S,
          "losses": losses, "grad_norms": [m["grad_norm"] for m in logs]})
    check(finite, f"a training loss is not finite: {losses}")
    expect_launches(launches, want, "slice_train")
    prof = device_profile(lambda: step(state, next(data)), 2, host=False)
    emit({"phase": "train_step_profile", "steps": 2, **{
        k.replace("_ms", "_ms_per_step"): v for k, v in prof.items()}})
    emit({"phase": "train_step_breakdown", "steps": 3,
          **step_breakdown(model, tc, state, data, 3)})
    return launches


def step_breakdown(model, tc, state, data, n: int):
    """Median wall ms of the parts of a training step, each ended by a
    device synchronize (so each part's host dispatch and device work are
    inside it): forward and loss, backward (the dX and dW GEMMs), and
    clipping plus the AdamW update; and the host-side enqueue of the
    forward alone."""
    from repro_torch.optim.optimizers import (clip_by_global_norm,
                                              make_optimizer)
    from repro_torch.runtime.trainer import _to_device

    _, update = make_optimizer(tc)
    parts = {"forward_ms": [], "forward_enqueue_ms": [], "backward_ms": [],
             "clip_and_adamw_ms": []}
    leaves = list(state["params"].values())
    for _ in range(n):
        batch = _to_device(next(data), model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        grads, _ = clip_by_global_norm(dict(zip(state["params"], grads)),
                                       tc.grad_clip)
        update(grads, state["opt"], state["params"],
               torch.full((), tc.lr, device=model.device))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in (("forward_ms", t2 - t0),
                        ("forward_enqueue_ms", t1 - t0),
                        ("backward_ms", t3 - t2),
                        ("clip_and_adamw_ms", t4 - t3)):
            parts[key].append(dt * 1e3)
        del loss, grads
    return {k: statistics.median(v) for k, v in parts.items()}


def step1_grads(model, batch):
    """Step 1's loss and gradients (by parameter name, on the model's
    device) of ``model`` on a numpy ``batch``."""
    params = dict(model.named_parameters())
    loss, _ = model.loss({k: torch.from_numpy(v).to(model.device)
                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def leaf_errors(got, want):
    """Per leaf: max |got - want| over the leaf's max |want|."""
    return {k: float((got[k] - w).abs().max() / (w.abs().max() + 1e-30))
            for k, w in want.items()}


def leaf_kinds(errs):
    """The worst error of each kind of leaf (the name less its layer)."""
    kinds = {}
    for k, e in errs.items():
        kind = ".".join(p for p in k.split(".") if not p.isdigit())
        kinds[kind] = max(kinds.get(kind, 0.0), e)
    return dict(sorted(kinds.items(), key=lambda kv: -kv[1]))


def norm64(tree) -> float:
    """The global norm of a tree of gradients, summed in f64 (each leaf's
    norm reduced in f64 without an f64 copy of the leaf)."""
    return math.sqrt(sum(float(torch.linalg.vector_norm(
        t, dtype=torch.float64)) ** 2 for t in tree.values()))


def grads_vs(got_loss, got, want_loss, want, want_norm: float):
    """Loss, global grad norm and per-leaf errors of one set of step-1
    gradients against another (``want_norm``: ``norm64(want)``)."""
    errs = leaf_errors(got, want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:8]
    return {"loss_rel": abs(got_loss - want_loss) / abs(want_loss),
            "grad_norm_rel": abs(norm64(got) - want_norm) / want_norm,
            "leaf_rel_max": worst[0][1], "worst_leaves": dict(worst),
            "by_kind": leaf_kinds(errs)}


def phase_train_fp32_vs_cpu(arch: str = "qwen2-0.5b",
                            n_layers: Optional[int] = None,
                            phase: str = "train_fp32_vs_cpu",
                            n_steps: int = 2):
    """``n_steps`` fp32 steps at full width (``n_layers`` cuts the depth)
    on the card and on the CPU from the same weights and batches (TF32
    off): loss and grad norm within 1e-4. Step 1's gradients are also held leaf by
    leaf (each within 1e-4 of its leaf's largest element), and once more
    with TF32 on as a control: a lower precision these limits must catch.
    The CPU's global norm is compared with the f64 sum, beside an f32
    ``torch._foreach_norm``."""
    from repro_torch.core.backends import baselines
    from repro_torch.core.precision import get_policy
    from repro_torch.optim.optimizers import global_norm

    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("fp32"), arch, n_layers)
    cpu_model = copy.deepcopy(model).to("cpu")
    batches = [data.batch_at(i) for i in range(n_steps)]
    cpu_loss, cpu_grads = step1_grads(cpu_model, batches[0])
    # the CPU's gradients are compared on the card (a copy of each leaf):
    # the f64 norms and per-leaf maxima of ~1.25 B values took ~31 s of
    # the MoE phase on the card's host, and the card takes a second
    want = {k: v.to(DEV) for k, v in cpu_grads.items()}
    exact = norm64(want)
    serial = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(cpu_grads.values()))))
    cpu_norm = {"global_norm_rel_to_f64":
                abs(float(global_norm(cpu_grads)) - exact) / exact,
                "f32_foreach_norm_rel_to_f64": abs(float(serial) - exact) /
                exact}
    del cpu_grads
    leaves = grads_vs(*step1_grads(model, batches[0]), cpu_loss, want, exact)
    pin = baselines._pin_full_f32   # the fp32 backend pins TF32 off
    baselines._pin_full_f32 = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = grads_vs(*step1_grads(model, batches[0]), cpu_loss, want,
                        exact)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        baselines._pin_full_f32 = pin
    del want
    card = plain = []
    card_s = cpu_s = 0.0
    rel = {"loss": [leaves["loss_rel"]],
           "grad_norm": [leaves["grad_norm_rel"]]}
    if n_steps > 1:
        # the trainer's own steps (step 1's loss and grad norm repeat the
        # step-1 comparison above, so one step needs no run)
        t0 = time.perf_counter()
        _, _, _, card = run_train(model, tc, iter(batches), n_steps)
        card_s = time.perf_counter() - t0
        del model
        t0 = time.perf_counter()
        _, _, _, plain = run_train(cpu_model, tc, iter(batches), n_steps)
        cpu_s = time.perf_counter() - t0
        rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(card, plain)]
               for k in ("loss", "grad_norm")}
    ok = max(max(v) for v in rel.values()) < 1e-4
    leaves_ok = leaves["leaf_rel_max"] < 1e-4
    tf32["caught_by_the_1e-4_limits"] = max(
        tf32["loss_rel"], tf32["grad_norm_rel"], tf32["leaf_rel_max"]) >= 1e-4
    emit({"phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "steps": n_steps, "card": card, "cpu": plain, "rel_err": rel,
          "step1_grads_tf32_off": leaves, "step1_grads_tf32_on": tf32,
          "cpu_step1_grad_norm": cpu_norm, "card_seconds": card_s,
          "cpu_seconds": cpu_s, "ok": ok and leaves_ok,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok, f"fp32 training on the card differs from the CPU by >= 1e-4 "
              f"relative: {rel}")
    check(leaves_ok, f"an fp32 step-1 gradient leaf on the card differs from "
                     f"the CPU's by >= 1e-4 of its largest element: "
                     f"{leaves['worst_leaves']}")


class _GradTap(torch.autograd.Function):
    """The identity on (x, w) that records the gradients ONE GEMM sends to
    them in the model's own backward: its dX and dW, as ``function_grads``
    would recompute them from (x, w, dO) on the same device."""

    @staticmethod
    def forward(ctx, x, w, rec):
        ctx.rec = rec
        return x.view_as(x), w.view_as(w)

    @staticmethod
    def backward(ctx, gx, gw):
        for name, g in (("dX", gx), ("dW", gw)):
            if g is not None:
                ctx.rec[name] = g.detach().clone()
        return gx, gw, None


class GemmCapture:
    """Records (x, w, dO) and the policy of the model GEMMs at the listed
    call indices by wrapping ``repro_torch.core.gemm.mirage_matmul`` (the
    differentiable op ``mirage_matmul_auto`` takes under grad); w keeps
    its layout. With ``grads`` the backward's dX and dW of each recorded
    GEMM are kept too (``_GradTap``), so the CPU side need not recompute
    them."""

    def __init__(self, keep, grads: bool = False):
        from repro_torch.core import gemm
        self.gemm, self.keep, self.calls, self.got = gemm, set(keep), 0, {}
        self.grads = grads

    def __enter__(self):
        self.inner = inner = self.gemm.mirage_matmul

        def recorded(x, w, policy):
            i = self.calls
            self.calls += 1
            if i not in self.keep:
                return inner(x, w, policy)
            rec = self.got[i] = {"x": x.detach().clone(), "w": w.detach(),
                                 "policy": policy}
            out = inner(*(_GradTap.apply(x, w, rec) if self.grads
                          else (x, w)), policy)
            out.register_hook(
                lambda g, rec=rec: rec.__setitem__("dO", g.detach().clone()))
            return out

        self.gemm.mirage_matmul = recorded
        return self

    def __exit__(self, *exc):
        self.gemm.mirage_matmul = self.inner


def to_card(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the card with its strides (a transposed view stays one)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=DEV).copy_(t)


def function_grads(x, w, dout, policy):
    """dX and dW of ``MirageMatmul`` at (x, w) for the upstream ``dout``."""
    from repro_torch.core import gemm

    x = x.clone().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    gemm.mirage_matmul(x, w, policy).backward(dout)
    return x.grad, w.grad


def cpu_capture(cpu_model, batch, layers, wsq_policy=None,
                gemms=LAYER_GEMMS, with_head: bool = True,
                prequantized=None):
    """The CPU's step-1 forward and backward with the ``gemms`` of
    ``layers`` and the head recorded; under ``wsq_policy`` on the
    weight-stationary copies, as the trainer runs it (``prequantized``:
    those copies, made already, by name). Returns (loss, capture, head
    index)."""
    from repro_torch.runtime.trainer import _Loss, _prequantize_params

    n_layers = len(cpu_model.layers)
    head = len(LAYER_GEMMS) * n_layers
    keep = [len(LAYER_GEMMS) * li + j for li in layers
            for j, name in enumerate(LAYER_GEMMS) if name in gemms] + \
        ([head] if with_head else [])
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    run = dict(cpu_model.named_parameters())
    with GemmCapture(keep, grads=True) as cap:
        if wsq_policy is None:
            loss, _ = cpu_model.loss(batch)
        else:
            run = _prequantize_params(run, wsq_policy, torch.float32) \
                if prequantized is None else {
                    k: v.detach().requires_grad_(True)
                    for k, v in prequantized.items()}
            loss, _ = torch.func.functional_call(
                _Loss(cpu_model), {f"model.{k}": v for k, v in run.items()},
                (batch,))
        torch.autograd.grad(loss, list(run.values()))
    return float(loss.detach()), cap, head


def teacher_forced(ref, cap, head):
    """The card's ``MirageMatmul`` on the CPU's (x, w, dO) of every
    captured GEMM, w in the layout the CPU's model gave it: dX and dW
    against the CPU's, within the GEMM check's bound. Returns (rows, the
    GEMMs outside it)."""
    rows, bad, n = {}, [], len(LAYER_GEMMS)
    for i, rec in sorted(cap.got.items()):
        name = "head" if i == head else f"layer_{i // n}.{LAYER_GEMMS[i % n]}"
        policy = rec["policy"]
        # the CPU backward's own dX and dW of this GEMM (recomputed only
        # where the backward sent it none)
        want = (rec["dX"], rec["dW"]) if "dX" in rec and "dW" in rec \
            else function_grads(rec["x"], rec["w"], rec["dO"], policy)
        x, w, d = to_card(rec["x"]), to_card(rec["w"]), to_card(rec["dO"])
        got = function_grads(x, w, d, policy)
        # a stack of experts (E, C, .) is held per expert as it is
        stack = w.dim() == 3
        d2 = d if stack else d.reshape(-1, d.shape[-1])
        x2 = x if stack else x.reshape(-1, x.shape[-1])
        as_is = policy.assume_quantized_weights
        bounds = (gemm_bound(ref, d2, w.transpose(-1, -2),
                             not as_is).reshape(x.shape),
                  gemm_bound(ref, x2.transpose(-1, -2), d2))
        errs = []
        for g, wv, tol in zip(got, want, bounds):
            e = (g - to_card(wv)).abs()
            errs.append((float(e.max()), float((e / tol).max())))
            if bool((e > tol).any()):
                bad.append(name)
        rows[name] = {"weight_as_is": as_is,
                      "dX_weight_read": weight_read(w.transpose(-1, -2)),
                      "dX_max_abs_err": errs[0][0],
                      "dX_err_over_tol": errs[0][1],
                      "dW_max_abs_err": errs[1][0],
                      "dW_err_over_tol": errs[1][1]}
    return rows, bad


def phase_train_grads_vs_cpu(ops, ref, layers=(0, 11, 23)):
    """Mirage at full width is chaotic end to end, so teacher-forced: the
    CPU's (x, w, dO) of every GEMM of layers 0, 11 and 23 and of the head,
    from its step-1 backward, go to the card's Function; its dX and dW must
    lie within the GEMM check's bound of the CPU's. Step 1's loss on both
    within 1e-3 relative."""
    from repro_torch.core.precision import get_policy

    policy = get_policy("mirage")
    cfg, model, tc, data = train_setup(policy)
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = data.batch_at(0)
    t0 = time.perf_counter()
    cpu_loss, cap, head = cpu_capture(cpu_model, batch, layers)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        card_loss, _ = model.loss({k: torch.from_numpy(v).to(DEV)
                                   for k, v in batch.items()})
    card_loss = float(card_loss)
    del model
    rows, bad = teacher_forced(ref, cap, head)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    ok = not bad and loss_rel < 1e-3
    emit({"phase": "train_grads_vs_cpu", "policy": "mirage", "gemms": rows,
          "step1_loss_card": card_loss, "step1_loss_cpu": cpu_loss,
          "step1_loss_rel_err": loss_rel, "cpu_seconds": cpu_s, "ok": ok})
    check(not bad, f"card dX/dW outside the GEMM bound of the CPU's at {bad}")
    check(loss_rel < 1e-3, f"step-1 loss card {card_loss} vs CPU "
                           f"{cpu_loss}: {loss_rel:.2e} relative")


def phase_slice_train_wsq(ops, ref, layers=(0, 11, 23),
                          arch: str = "qwen2-0.5b",
                          n_layers: Optional[int] = None,
                          phase: str = "slice_train_wsq",
                          card_copies: bool = False):
    """3 steps with weight-stationary quantization and BFP gradient
    compression: kernel #2 quantizes every GEMM weight (an expert stack is
    one launch over its (E * N, K) rows) and every non-scalar gradient leaf
    each step. Step 1's loss against the CPU's, and its GEMMs
    teacher-forced as in ``train_grads_vs_cpu``: the CPU's (x, w, dO) of
    ``layers`` and the head, w the trainer's transposed view of a
    contiguous (N, K) copy (of an (E, N, K) stack for the experts), so dX
    runs the kernel on that contiguous copy as it is. ``n_layers`` cuts
    the depth of ``arch`` as ``--layers`` does. ``card_copies``: the CPU
    step takes its weight-stationary copies from the card's quantizer
    (kernel 2), with the first quantized leaf and the first expert stack
    held to the CPU's own quantizer; otherwise the CPU quantizes its
    own."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.trainer import (_prequantize_params,
                                             _quantized_names)

    t_phase = time.perf_counter()
    policy = get_policy("mirage", assume_quantized_weights=True)
    cfg, model, tc, data = train_setup(policy, arch, n_layers,
                                       weight_stationary_quant=True,
                                       grad_compression="bfp")
    cpu_model = copy.deepcopy(model).to("cpu")
    batches = [data.batch_at(i) for i in range(WSQ_STEPS)]
    params = dict(model.named_parameters())
    pre, held = None, []
    if card_copies:
        # the CPU step's weight-stationary copies: the card's quantizer
        # (kernel 2, bit for bit the plain one: phase bfp) on step 1's
        # weights, copied over; the CPU's plain quantizer took ~8 s over
        # mixtral's experts. The first quantized leaf and the first expert
        # stack are held to the CPU's own quantizer here.
        pre = {k: v.detach().to("cpu") for k, v in _prequantize_params(
            params, policy, torch.float32).items()}
        names = _quantized_names(params)
        held = names[:1] + [n for n in names if params[n].dim() == 3][:1]
        for name in held:
            own = _prequantize_params({name: cpu_model.get_parameter(name)},
                                      policy, torch.float32)[name]
            check(torch.equal(own, pre[name]), f"{phase}: the card's "
                  f"weight-stationary copy of {name} differs from the CPU "
                  f"quantizer's")
            del own
    n_quant = len(_quantized_names(params))
    n_leaves = sum(1 for p in params.values() if p.dim() > 0)
    per_step = 7 * cfg.n_layers + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    _, _, times, logs = run_train(model, tc, iter(batches), WSQ_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    free_card()
    want = {"mirage_gemm": 3 * per_step * WSQ_STEPS,
            "bfp_quantize": (n_quant + n_leaves) * WSQ_STEPS}
    t0 = time.perf_counter()
    cpu_loss, cap, head = cpu_capture(cpu_model, batches[0], layers, policy,
                                      prequantized=pre)
    cpu_s = time.perf_counter() - t0
    del cpu_model, pre
    rows, bad = teacher_forced(ref, cap, head)
    # dX = dO @ W^T must read the contiguous (N, K) copy as a row-major
    # (K' = N, N' = K) operand, the kernel's quantize-skipping (K, N) route
    wrong_layout = [n for n, r in rows.items() if n != "head" and
                    r["dX_weight_read"] != "(K, N) row-major"]
    stacks = sum(1 for r in cap.got.values() if r["w"].dim() == 3)
    losses = [m["loss"] for m in logs]
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    emit({"phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "steps": WSQ_STEPS, "quantized_weights": n_quant,
          "gradient_leaves": n_leaves, "launches": launches,
          "expected_launches": want,
          "step_ms": [t * 1e3 for t in times], "peak_mem_gb": peak,
          "losses": losses, "cpu_step1_loss": cpu_loss,
          "step1_loss_rel_err": rel, "gemms": rows,
          "expert_stacks_teacher_forced": stacks, "cpu_seconds": cpu_s,
          "cpu_copies": "the card's, these held to the CPU quantizer: "
                        f"{held}" if card_copies else "the CPU's own",
          "ok": rel < 1e-3 and not bad and not wrong_layout,
          "phase_seconds": time.perf_counter() - t_phase})
    check(all(math.isfinite(v) for v in losses),
          f"{phase}: a weight-stationary training loss is not finite: "
          f"{losses}")
    expect_launches(launches, want, phase)
    check(rel < 1e-3, f"{phase}: step-1 loss card {losses[0]} vs CPU "
                      f"{cpu_loss}: {rel:.2e} relative")
    check(not wrong_layout, f"{phase}: a weight-stationary dX did not read "
                            f"the contiguous (N, K) copy: {wrong_layout}")
    check(not bad, f"{phase}: card dX/dW outside the GEMM bound of the "
                   f"CPU's at {bad}")
    check(stacks == 3 * len(layers) * (cfg.n_experts > 0),
          f"{phase}: {stacks} expert stacks teacher-forced")
    return launches


# --------------------------------------------------------------------------
# phases 13-16: closing slice 2 — serve --reduced through flash at D = 16,
# checkpoint and resume at full width, mirage_rns training at full width,
# and the example twins
# --------------------------------------------------------------------------

#: scratch for the checkpoints of train_resume and the twins, removed after
CKPT_ROOT = pathlib.Path(__file__).resolve().parent / "build" / \
    "chip_smoke_ckpt"
RESUME_STEPS, RNS_TRAIN_STEPS = 4, 2
#: the stop-and-resume run's depth (4 of qwen2-0.5b's 24 layers, the
#: script's time limit: its three runs wrote full-width checkpoints;
#: checkpoint_times keeps the full-width state)
RESUME_LAYERS = 4
RNS_TRAIN_PEAK_GB = 24.0


def entry_argv(argv, reduced: bool = False):
    """An entry point's arguments; a CPU rehearsal adds ``--device cpu``
    (and, for the launchers, ``--reduced``)."""
    extra = ["--reduced"] if reduced and REDUCED else []
    return argv + extra + (["--device", "cpu"] if DEV == "cpu" else [])


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured; returns (result,
    the output's last lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()[-6:]


def free_card():
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_serve_reduced(ops):
    """``python -m repro_torch.launch.serve --reduced`` on the card: the
    reduced config's head_dim 16 through the flash kernel's D = 16
    instance. Under fp32 the greedy streams equal the CPU's on the same
    weights (the card's model copied to the CPU)."""
    from repro_torch.launch import serve as serve_launch

    ops.reset_launch_counts()
    rc, lines = quiet(serve_launch.main, entry_argv(["--reduced"]))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    args = serve_launch.parse_args(entry_argv(["--reduced", "--policy",
                                               "fp32"]))
    model = serve_launch.build(args)
    cpu_model = copy.deepcopy(model).to("cpu")
    _, card, _ = serve_launch.serve(model, args)
    _, cpu, _ = serve_launch.serve(cpu_model, args)
    streams = {r.rid: r.tokens_out for r in card}
    cpu_streams = {r.rid: r.tokens_out for r in cpu}
    n_layers = model.cfg.n_layers
    same = streams == cpu_streams and len(streams) == args.requests
    emit({"phase": "serve_reduced", "head_dim": model.cfg.resolved_head_dim,
          "returncode": rc, "output": lines, "launches": launches,
          "fp32_streams_equal_cpu": same,
          "fp32_tokens": sum(len(t) for t in streams.values()),
          "ok": rc == 0 and launches["flash_attention"] > 0 and same})
    check(rc == 0, "launch.serve --reduced did not return 0")
    check(launches["flash_attention"] > 0 and
          launches["flash_attention"] % n_layers == 0,
          f"launch.serve --reduced launched flash {launches} times")
    check(same, f"fp32 greedy streams on the card differ from the CPU's: "
                f"{streams} vs {cpu_streams}")
    del model, cpu_model
    free_card()
    return launches


def read_checkpoint(d: pathlib.Path):
    """A checkpoint directory's manifest and leaves, as the JAX package
    writes them (``format: 1``)."""
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, {p: np.load(d / f)
                      for p, f in manifest["leaves"].items()}


def phase_train_resume():
    """Full width under mirage through ``launch.train.main`` (at
    RESUME_LAYERS of the 24 layers, ``--layers``): 4 steps
    straight, against 2 steps, SIGTERM (the guard checkpoints and stops),
    ``--resume`` and 2 more. The step-4 checkpoints (params, both moments
    and their count, the step, and the data state in the metadata) must be
    equal bit for bit. Then the full-width state's checkpoint bytes and its
    synchronous save, asynchronous save and restore times."""
    import shutil
    import signal
    from repro_torch.launch import train as train_launch
    from repro_torch.runtime.elastic import StragglerMitigator

    class SigtermAtStop(StragglerMitigator):
        """Sends the process SIGTERM after step RESUME_STEPS / 2: the
        launcher's PreemptionGuard takes it as it would the scheduler's."""

        def record(self, step, dt):
            if step == RESUME_STEPS // 2:
                signal.raise_signal(signal.SIGTERM)
            return super().record(step, dt)

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    disk_free_gb = shutil.disk_usage(CKPT_ROOT).free / 1e9
    straight, stopped = CKPT_ROOT / "straight", CKPT_ROOT / "stopped"
    common = entry_argv(["--ckpt-every", str(RESUME_STEPS),
                         "--layers", str(RESUME_LAYERS)], reduced=True)
    t0 = time.perf_counter()
    quiet(train_launch.main, ["--steps", str(RESUME_STEPS), "--ckpt-dir",
                              str(straight)] + common)
    free_card()
    want_manifest, want = read_checkpoint(
        straight / f"step_{RESUME_STEPS:010d}")
    shutil.rmtree(straight)
    real = train_launch.StragglerMitigator
    train_launch.StragglerMitigator = SigtermAtStop
    try:
        _, stop_lines = quiet(train_launch.main, [
            "--steps", str(RESUME_STEPS), "--ckpt-dir", str(stopped)]
            + common)
    finally:
        train_launch.StragglerMitigator = real
    free_card()
    stopped_at = sorted(p.name for p in stopped.iterdir())
    _, resume_lines = quiet(train_launch.main, [
        "--steps", str(RESUME_STEPS - RESUME_STEPS // 2), "--resume",
        "--ckpt-dir", str(stopped)] + common)
    free_card()
    got_manifest, got = read_checkpoint(stopped / f"step_{RESUME_STEPS:010d}")
    runs_s = time.perf_counter() - t0
    differ = [p for p in want if p not in got or
              not np.array_equal(want[p], got[p]) or
              want[p].dtype != got[p].dtype]
    same_meta = want_manifest["metadata"] == got_manifest["metadata"]
    n_bytes = sum(a.nbytes for a in want.values())
    emit({"phase": "train_resume", "policy": "mirage", "steps":
          RESUME_STEPS, "stopped_after": RESUME_STEPS // 2,
          "checkpoints_after_stop": stopped_at, "stop_output": stop_lines,
          "resume_output": resume_lines, "leaves": len(want),
          "leaves_differing": differ[:10], "metadata": got_manifest[
              "metadata"], "metadata_equal": same_meta,
          "checkpoint_bytes": n_bytes, "disk_free_gb_before": disk_free_gb,
          "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
          "seconds": runs_s, "ok": not differ and same_meta})
    check(stopped_at == [f"step_{RESUME_STEPS // 2:010d}"],
          f"the stopped run left {stopped_at}")
    check(not differ, f"resumed state differs from the straight run at "
                      f"{differ[:10]}")
    check(same_meta, f"data state differs: {want_manifest['metadata']} vs "
                     f"{got_manifest['metadata']}")
    del want, got
    shutil.rmtree(stopped)
    checkpoint_times()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def checkpoint_times():
    """Save (synchronous, and asynchronous: the call, then to the commit)
    and restore of the full-width mirage train state after one step."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.precision import get_policy
    from repro_torch.interop import restore_train_state, to_jax_train_state

    cfg, model, tc, data = train_setup(get_policy("mirage"))
    state, _, _, _ = run_train(model, tc, iter(data), 1)
    ck = Checkpointer(str(CKPT_ROOT / "timing"), keep_last=1)
    t0 = time.perf_counter()
    ck.save(to_jax_train_state(model, state), 1)
    sync_s = time.perf_counter() - t0
    d = CKPT_ROOT / "timing" / f"step_{1:010d}"
    n_bytes = sum(f.stat().st_size for f in d.iterdir())
    shutil.rmtree(d)    # one full-width checkpoint on the disk at a time
    t0 = time.perf_counter()
    ck.save_async(to_jax_train_state(model, state), 2)
    call_s = time.perf_counter() - t0
    ck.wait()
    async_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in
              (("emb", model.embed.emb), ("m", state["opt"]["m"][
                  "embed.emb"]))}
    with torch.no_grad():
        model.embed.emb.zero_()
        state["opt"]["m"]["embed.emb"].zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, meta = restore_train_state(ck, model, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ok = torch.equal(model.embed.emb, before["emb"]) and torch.equal(
        state["opt"]["m"]["embed.emb"], before["m"]) and \
        int(state["step"]) == 1
    emit({"phase": "checkpoint_times", "policy": "mirage",
          "params": sum(p.numel() for p in model.parameters()),
          "files_bytes": n_bytes, "save_sync_s": sync_s,
          "save_async_call_s": call_s, "save_async_to_commit_s": async_s,
          "restore_s": restore_s, "sync_gb_per_s": n_bytes / sync_s / 1e9,
          "ok": ok})
    check(ok, "the full-width restore did not bring the state back")
    del model, state
    free_card()


def rns_blocks_per_step(cfg, T: int) -> int:
    """Kernel-4 launches of one mirage_rns training step at T tokens, from
    the card's group-block plan: per model GEMM (K -> N) the forward (M = T
    over K), dX (M = T over N) and dW (M = K over T)."""
    from repro_torch.core.backends.mirage_rns import card_group_block

    def launches(M, K, N):
        G = -(-K // 16)
        return -(-G // card_group_block(3, G, M, N))

    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    return sum(n * (launches(T, K, N) + launches(T, N, K) +
                    launches(K, T, N))
               for K, N, n in ((d, d, 2 * L), (d, kv, 2 * L),
                               (d, f, 2 * L), (f, d, L), (d, V, 1)))


def phase_slice_train_rns(ops, ref, layers=(0, 23)):
    """2 full-width mirage_rns steps: every forward, dX and dW GEMM through
    kernel 4, launched over group blocks wherever one launch's residues
    would pass the budget (the tied head). Losses finite, peak memory
    below 24 GB, launches as the plan says; step 1's GEMMs of the listed
    layers (``main`` lists layer 0) and the head, teacher-forced (the
    card's own x, w and dO of step 1),
    within the GEMM bound of mirage_fast: the forward, dX and dW."""
    from repro_torch.core import gemm
    from repro_torch.core.precision import get_policy

    policy, fast = get_policy("mirage_rns"), get_policy("mirage")
    cfg, model, tc, data = train_setup(policy)
    layers = tuple(li for li in layers if li < cfg.n_layers)
    data = iter(data)
    T = TRAIN_BATCH * TRAIN_SEQ
    head = len(LAYER_GEMMS) * cfg.n_layers
    keep = [len(LAYER_GEMMS) * li + j for li in layers
            for j in range(len(LAYER_GEMMS))] + [head]
    per_step = rns_blocks_per_step(cfg, T)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    with GemmCapture(keep) as cap:
        state, _, times, logs = run_train(model, tc, data, 1)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows, bad = {}, []
    n = len(LAYER_GEMMS)
    for i, rec in sorted(cap.got.items()):
        name = "head" if i == head else f"layer_{i // n}.{LAYER_GEMMS[i % n]}"
        x = rec["x"].reshape(-1, rec["x"].shape[-1])
        w, d = rec["w"], rec["dO"].reshape(-1, rec["dO"].shape[-1])
        errs = {}
        for part, (a, b) in (("fwd", (x, w)), ("dX", (d, w.T)),
                             ("dW", (x.T, d))):
            got = gemm.mirage_matmul_nograd(a, b, policy)
            want_f = gemm.mirage_matmul_nograd(a, b, fast)
            e = (got - want_f).abs()
            tol = gemm_bound(ref, a.contiguous(), b)
            errs[part] = {"max_abs_err": float(e.max()),
                          "err_over_tol": float((e / tol).max())}
            if bool((e > tol).any()):
                bad.append(f"{name}.{part}")
            del got, want_f, e, tol
        rows[name] = errs
    del cap
    free_card()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, step, more, logs2 = run_train(model, tc, data,
                                         RNS_TRAIN_STEPS - 1, state=state)
    torch.cuda.synchronize()
    launches = {k: v + launches[k] for k, v in ops.LAUNCHES.items()}
    peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
    prof = device_profile(lambda: step(state, next(data)), 1, host=False)
    times, logs = times + more, logs + logs2
    losses = [m["loss"] for m in logs]
    want = {"rns_matmul": per_step * RNS_TRAIN_STEPS}
    tokens = T
    step_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    emit({"phase": "slice_train_rns", "arch": cfg.arch_id,
          "policy": "mirage_rns b_m=4 g=16 k=5", "steps": RNS_TRAIN_STEPS,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "launches": launches,
          "expected_launches": want, "rns_matmul_per_step": per_step,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_from_2": step_s * 1e3,
          "tok_per_s": tokens / step_s, "peak_mem_gb": peak,
          "allocated_before_gb": before, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in logs],
          "step1_gemms_vs_mirage_fast": rows, "step_profile": prof,
          "ok": not bad and peak < RNS_TRAIN_PEAK_GB and
          all(math.isfinite(v) for v in losses)})
    check(all(math.isfinite(v) for v in losses),
          f"a mirage_rns training loss is not finite: {losses}")
    expect_launches(launches, want, "slice_train_rns")
    check(peak < RNS_TRAIN_PEAK_GB, f"mirage_rns training peaked at "
                                    f"{peak:.2f} GB")
    check(not bad, f"mirage_rns step-1 GEMMs outside mirage_fast's bound at "
                   f"{bad}")
    del model, state
    free_card()
    return launches, per_step


def phase_twins(ops):
    """Each example twin, as ``python -m repro_torch.examples.<name>`` runs
    it, on the card: it must return 0. The training twin stops early (3
    steps) and checkpoints into a scratch directory."""
    import shutil
    from repro_torch.examples import (mirage_vs_fp32, quickstart, serve_lm,
                                      train_lm)

    runs = {"quickstart": (quickstart.main, []),
            "mirage_vs_fp32": (mirage_vs_fp32.main, ["--snr-db", "45",
                                                     "--rrns"]),
            "train_lm": (train_lm.main, ["--small", "--steps", "3",
                                         "--ckpt-dir",
                                         str(CKPT_ROOT / "train_lm")]),
            "serve_lm": (serve_lm.main, [])}
    out = {}
    for name, (fn, argv) in runs.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc, lines = quiet(fn, entry_argv(argv))
        torch.cuda.synchronize()
        out[name] = {"argv": argv, "returncode": rc,
                     "seconds": time.perf_counter() - t0,
                     "launches": dict(ops.LAUNCHES), "output": lines}
        free_card()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    ok = all(r["returncode"] == 0 for r in out.values())
    emit({"phase": "twins", "runs": out, "ok": ok})
    check(ok, f"an example twin did not return 0: "
              f"{ {k: v['returncode'] for k, v in out.items()} }")
    check(out["serve_lm"]["launches"]["flash_attention"] > 0 and
          out["quickstart"]["launches"]["mirage_gemm"] > 0 and
          out["mirage_vs_fp32"]["launches"]["rns_matmul_channel"] > 0 and
          out["mirage_vs_fp32"]["launches"]["rrns_decode"] > 0,
          "a twin did not reach the kernels of its path")
    return out


def phase_timing_train(ops, ref, policy):
    """The backward GEMMs (and the weight-stationary forward) at B x L =
    256: kernel, plain, library (``torch.matmul`` on pre-folded operands)
    and bound; and the one transposing copy of X that the dW GEMM's wrapper
    makes."""
    rows = []
    T = TRAIN_TOKENS[0]
    for i, (name, K, N, qw) in enumerate(bwd_cases(T)):
        a, b = bwd_operands(name, T, K, N, seed=900 + i)
        aq = ref.bfp_fake_quant_ref(a, policy.b_m, policy.g)
        bq = ref.bfp_fake_quant_ref(b.T, policy.b_m, policy.g).T \
            if qw else b
        M, Kc, Nout = a.shape[0], a.shape[1], b.shape[1]
        plan = card_gemm_plan(ops, M, Kc, Nout, policy.b_m, qw)
        t_b, by = bound_rate(4.0 * (M * Kc + Kc * Nout + M * Nout),
                             2.0 * M * Nout * Kc,
                             BF16_FLOPS_PER_S if plan.mma
                             else F32_FLOPS_PER_S)
        rows.append({
            "gemm": name, "M": M, "K": Kc, "N": Nout, "layer_K": K,
            "layer_N": N, "weight_read": weight_read(b),
            "route": "mma_bf16" if plan.mma else "decode_f32",
            "splits": plan.splits,
            "launches_per_train_step": GEMM_PER_STEP[(K, N)],
            "ms": time_ms(lambda: ops.mirage_matmul_fused(
                a, b, policy, quantize_w=qw)),
            "plain_ms": time_ms(lambda: ref.mirage_gemm_ref(
                a, b, policy.b_m, policy.g, quantize_w=qw),
                **PLAIN_TIMING),
            "library_ms": time_ms(lambda: torch.matmul(aq, bq)),
            "bound_ms": t_b, "bound_by": by})
        if name == "dW":
            t_b, by = bound(8.0 * a.numel(), 0.0)
            rows.append({"gemm": "dW X^T copy", "M": M, "K": Kc,
                         "launches_per_train_step": GEMM_PER_STEP[(K, N)],
                         "ms": time_ms(lambda: a.contiguous()),
                         "plain_ms": None, "library_ms": None,
                         "bound_ms": t_b, "bound_by": by})
        del a, b, aq, bq
    for row in rows:
        emit({"phase": "timing", "kernel": "mirage_gemm", "path": "train",
              **row})
    return rows


# --------------------------------------------------------------------------
# phase 7: timing at the slice shapes
# --------------------------------------------------------------------------

def phase_timing(ops, ref, policy, per_tick):
    rows = {"mirage_gemm": [], "flash_attention": [], "bfp_quantize": []}
    for M in GEMM_M:
        for K, N in GEMM_KN:
            x, w = gemm_operands(M, K, N, seed=1)
            xq, wq = folded(ref, x, w, policy)
            plan = card_gemm_plan(ops, M, K, N, policy.b_m)
            # operations at the rate of the units the route runs them on
            t_b, by = bound_rate(4.0 * (M * K + K * N + M * N),
                                 2.0 * M * N * K,
                                 BF16_FLOPS_PER_S if plan.mma
                                 else F32_FLOPS_PER_S)
            rows["mirage_gemm"].append({
                "M": M, "K": K, "N": N,
                "route": "mma_bf16" if plan.mma else "decode_f32",
                "splits": plan.splits,
                # launches of this (K, N) per decode tick and per prefill
                # batch; M is the slots at decode, batch x bucket at prefill
                "launches_per_step": per_tick[(K, N)],
                "ms": time_ms(lambda: ops.mirage_matmul_fused(x, w, policy)),
                "plain_ms": time_ms(lambda: ref.mirage_gemm_ref(
                    x, w, policy.b_m, policy.g), **PLAIN_TIMING),
                "library_ms": time_ms(lambda: torch.matmul(xq, wq)),
                "bound_ms": t_b, "bound_by": by})
    for i, (B, L, H, Kv, D, window) in enumerate(FLASH_TIMED):
        q, k, v = flash_operands(B, L, H, Kv, D, seed=7 + i)
        pos = torch.arange(L, device=DEV)
        allowed = pos[:, None] >= pos[None, :]
        if window is not None:
            allowed &= pos[:, None] - pos[None, :] < window
        pairs = int(allowed.sum())          # (q, k) pairs this data needs
        moved = 4.0 * (2 * B * L * H * D + 2 * B * L * Kv * D)
        flops = 4.0 * B * H * pairs * D     # Q K^T and P V
        # the route's unit rate: 3 TF32 products per product (3xTF32)
        t_b, by = bound_rate(moved, 3 * flops, TF32_FLOPS_PER_S)
        t_f32, by_f32 = bound(moved, flops)
        lib = sdpa_yardstick(ref, q, k, v, window, allowed)
        rows["flash_attention"].append({
            "B": B, "L": L, "H": H, "Kv": Kv, "D": D, "window": window,
            "launches_per_prefill_batch": 24, "launches_per_decode_tick": 0,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, True, window)),
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(
                q, k, v, True, window), **PLAIN_TIMING),
            "library_ms": lib["ms"], "library": lib["name"],
            "sdpa_ms_by_backend": lib["by_backend"],
            "sdpa_repeated_kv_ms_by_backend": lib["repeated_kv_by_backend"],
            "sdpa_max_abs_err": lib["max_abs_err"],
            "bound_ms": t_b, "bound_by": by,
            "bound_unit": "TF32 tensor cores, 3 products (3xTF32)",
            "bound_f32_ms": t_f32, "bound_f32_by": by_f32})
    for rows_k, k_dim, misaligned in ((4096, 4864, False), (8, 896, False),
                                      (4096, 4864, True)):
        x = bfp_operand(rows_k, k_dim, 3, misaligned)
        t_b, by = bound(8.0 * rows_k * k_dim, 0.0)
        rows["bfp_quantize"].append({
            # on the serving path the quantizer runs inside mirage_gemm
            "rows": rows_k, "K": k_dim, "launches_per_step": 0,
            "route": ops.bfp_quant_plan(k_dim, policy.g,
                                        x.data_ptr() % 16 == 0),
            "misaligned_view": misaligned,
            "ms": time_ms(lambda: ops.bfp_fake_quant(x, policy)),
            "plain_ms": time_ms(lambda: ref.bfp_fake_quant_ref(
                x, policy.b_m, policy.g), **PLAIN_TIMING),
            "library_ms": None, "bound_ms": t_b, "bound_by": by})
    # weight-stationary training with BFP gradient compression: the
    # quantizer's standalone launches per step, by (rows, K): each GEMM
    # weight as its transposed copy, each gradient leaf along its last axis
    # (the tied embedding's gradient is the largest launch)
    wsq_shapes = {(151936, 896): 1, (4864, 896): 72, (896, 4864): 72,
                  (896, 896): 96, (128, 896): 48, (896, 128): 48}
    gen = torch.Generator(device=DEV).manual_seed(4)
    for (rows_k, k_dim), n in wsq_shapes.items():
        x = torch.randn((rows_k, k_dim), generator=gen, device=DEV) * 1e-3
        t_b, by = bound(8.0 * rows_k * k_dim, 0.0)
        rows["bfp_quantize"].append({
            "rows": rows_k, "K": k_dim, "path": "train_wsq_bfp",
            "launches_per_step": n,
            "route": ops.bfp_quant_plan(k_dim, policy.g),
            "misaligned_view": False,
            "ms": time_ms(lambda: ops.bfp_fake_quant(x, policy)),
            "plain_ms": time_ms(lambda: ref.bfp_fake_quant_ref(
                x, policy.b_m, policy.g), **PLAIN_TIMING),
            "library_ms": None, "bound_ms": t_b, "bound_by": by})
        del x
    for name, shapes in rows.items():
        for row in shapes:
            emit({"phase": "timing", "kernel": name, **row})
    return rows


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION", "MATH")


def sdpa_backends(fn):
    """Each scaled_dot_product_attention backend's time for ``fn`` (None
    where the backend refuses the call), and its output."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times, outs = {}, {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def call(backend=backend):
            with sdpa_kernel(backend):
                return fn()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                outs[name] = call()
                torch.cuda.synchronize()
                times[name] = time_ms(call)
        except RuntimeError:
            times[name] = None
    return times, outs


def sdpa_yardstick(ref, q, k, v, window, allowed, causal: bool = True):
    """PyTorch's scaled_dot_product_attention on the same f32 inputs, as
    (B, heads, L, D) copies with enable_gqa: is_causal where there is no
    window (no mask tensor), the boolean mask otherwise, and neither where
    the call is not causal. The fastest backend that accepts the call is
    the yardstick. Beside it, not the yardstick: each backend on K/V
    repeated to every query head beforehand (another call, reading rep x
    the K/V bytes)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = {"attn_mask": allowed} if window is not None else (
        {"is_causal": True} if causal else {})
    by_backend, outs = sdpa_backends(
        lambda: sdpa(qt, kt, vt, enable_gqa=True, **kw))
    ms, name = min((t, n) for n, t in by_backend.items() if t is not None)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    rep = q.shape[2] // k.shape[2]
    kr, vr = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
    repeated, _ = sdpa_backends(lambda: sdpa(qt, kr, vr, **kw))
    return {"ms": ms, "name": f"sdpa {name.lower()}", "by_backend":
            by_backend, "repeated_kv_by_backend": repeated,
            "max_abs_err": float((outs[name].transpose(1, 2) - want)
                                 .abs().max())}


def decode_ops_per_subset(n_total: int) -> int:
    """f32 operations the decode does per element and subset: the
    reconstruction (n_total multiplies, n_total - 1 adds), the fold (9), a
    6-operation congruence check per modulus, and the vote (4)."""
    return 2 * n_total - 1 + 9 + 6 * n_total + 4


def subsets_needed(res: torch.Tensor, tables) -> torch.Tensor:
    """Per element, the subsets the decode evaluates before it stops: up to
    the first whose X every residue agrees with and |X| <= psi (the
    largest vote), all S where none does. Exact integer arithmetic, apart
    from the kernel and its plain version."""
    r = res.to(torch.int64)
    needed = torch.full(r.shape[1:], tables.n_subsets, dtype=torch.int64,
                        device=r.device)
    for s in reversed(range(tables.n_subsets)):
        M_s = int(tables.subset_M[s])
        acc = torch.zeros_like(needed)
        for j in tables.subsets[s]:
            acc = torch.remainder(acc + r[j] * int(tables.weights[s, j]), M_s)
        X = torch.where(acc > int(tables.subset_psi[s]), acc - M_s, acc)
        full = X.abs() <= tables.psi
        for i, m in enumerate(tables.moduli):
            full &= torch.remainder(X - r[i], m) == 0
        needed = torch.where(full, s + 1, needed)
    return needed


def decode_timing_row(ops, ref, res, tables, shape):
    """The decode's times on ``res`` beside its bound, which counts the
    work these inputs need: each element's subsets up to its first largest
    vote."""
    n, E = res.shape[0], res[0].numel()
    n_sub = int(subsets_needed(res, tables).sum())
    t_b, by = bound_rate(4.0 * n * E + 8.0 * E,
                         float(n_sub) * decode_ops_per_subset(n),
                         F32_FLOPS_PER_S)
    return {**shape, "E": E, "subsets_per_element": n_sub / E,
            "ms": time_ms(lambda: ops.rrns_decode(res, tables)),
            "plain_ms": time_ms(lambda: ref.rrns_decode_ref(res, tables),
                                **PLAIN_TIMING),
            "library_ms": None, "bound_ms": t_b, "bound_by": by}


def phase_timing_rns(ops, ref, per_tick):
    """Kernels 4, 5 and 6 at the decode tick (M = 4) and the largest prefill
    batch (M = 512) of every slice GEMM, over the RRNS moduli, on encoded
    BFP mantissas with 52 dB detector noise: the residues the decode meets
    on the serving path."""
    from repro_torch.analog import rrns

    psi = (math.prod(RNS_BASE) - 1) // 2
    tables = rrns.get_tables(RRNS_ALL, len(RNS_BASE), psi)
    rows = {"rns_matmul": [], "rns_matmul_channel": [], "rrns_decode": []}
    n = len(RRNS_ALL)
    for M in RNS_M:
        for K, N in GEMM_KN:
            if M > SLOTS and N == 151936:
                continue
            G = K // 16
            S, E = n * G, G * M * N
            xr, wr = encoded_residue_operands(RRNS_ALL, M, K, N, seed=1)
            gen = torch.Generator(device=DEV).manual_seed(2)
            noise = detector_noise(RRNS_ALL, (G, M, N), SNR_DB, gen)
            xf = xr.reshape(S, M, 16).float()
            wf = wr.reshape(S, 16, N).float()
            shape = {"M": M, "K": K, "N": N, "n_mod": n, "G": G,
                     "launches_per_step": per_tick[(K, N)]}
            b4 = 4.0 * (S * M * 16 + S * 16 * N + S * M * N)
            o4 = 2.0 * S * M * N * 16
            t_b, by = bound_rate(b4, o4, INT_OPS_PER_S)
            rows["rns_matmul"].append({
                **shape,
                "ms": time_ms(lambda: ops.rns_group_matmul(xr, wr,
                                                           RRNS_ALL)),
                "plain_ms": time_ms(lambda: ref.rns_matmul_ref(
                    xr, wr, RRNS_ALL), **PLAIN_TIMING),
                "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
                "bound_ms": t_b, "bound_by": by})
            t_b, by = bound_rate(b4 + 4.0 * S * M * N, o4, INT_OPS_PER_S)
            rows["rns_matmul_channel"].append({
                **shape,
                "ms": time_ms(lambda: ops.rns_group_matmul_channel(
                    xr, wr, RRNS_ALL, noise)),
                "plain_ms": time_ms(lambda: ref.rns_matmul_channel_ref(
                    xr, wr, RRNS_ALL, noise), **PLAIN_TIMING),
                "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
                "bound_ms": t_b, "bound_by": by})
            res = ops.rns_group_matmul_channel(xr, wr, RRNS_ALL, noise)
            del noise, xf, wf
            rows["rrns_decode"].append(decode_timing_row(
                ops, ref, res, tables, {**shape, "inputs": "path"}))
            if N == 151936:
                # the inputs of the earlier timing: independent random
                # residues per modulus, where every element runs all subsets
                res = random_residues(RRNS_ALL, (G, M, N), torch.Generator(
                    device=DEV).manual_seed(3)).reshape(n, G, M, N)
                rows["rrns_decode"].append(decode_timing_row(
                    ops, ref, res, tables,
                    {**shape, "inputs": "random residue tuples"}))
            del res
    for name, shapes in rows.items():
        for row in shapes:
            emit({"phase": "timing", "kernel": name, **row})
    return rows


#: kernel 4's launches in a full-width mirage_rns training step at 256
#: tokens, by (GEMM, groups per launch, M, N) and launches a step: the
#: layer forwards, and the tied head's blocks (card_group_block)
RNS_TRAIN_SHAPES = (("fwd q/o", 56, 256, 896, 48),
                    ("fwd gate/up", 56, 256, 4864, 48),
                    ("fwd down", 304, 256, 896, 24),
                    ("head fwd block", 4, 256, 151936, 14),
                    ("head dX block", 780, 256, 896, 13),
                    ("head dW block", 1, 896, 151936, 16))


def phase_timing_train_rns(ops, ref):
    """Kernel 4 at the launches of a full-width mirage_rns training step,
    over the base moduli: kernel, plain version, ``torch.bmm`` of the same
    residues as f32 (no mod) and the bound."""
    rows = []
    n = len(RNS_BASE)
    for name, G, M, N, per_step in RNS_TRAIN_SHAPES:
        xr, wr = residue_operands(RNS_BASE, M, 16 * G, N, seed=11)
        S = n * G
        xf, wf = xr.reshape(S, M, 16).float(), wr.reshape(S, 16, N).float()
        t_b, by = bound_rate(4.0 * (S * M * 16 + S * 16 * N + S * M * N),
                             2.0 * S * M * N * 16, INT_OPS_PER_S)
        rows.append({
            "gemm": name, "n_mod": n, "G": G, "M": M, "N": N,
            "launches_per_train_step": per_step,
            "ms": time_ms(lambda: ops.rns_group_matmul(xr, wr, RNS_BASE)),
            "plain_ms": time_ms(lambda: ref.rns_matmul_ref(xr, wr, RNS_BASE),
                                **PLAIN_TIMING),
            "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
            "bound_ms": t_b, "bound_by": by})
        del xr, wr, xf, wf
    for row in rows:
        emit({"phase": "timing", "kernel": "rns_matmul", "path": "train",
              **row})
    return rows


# --------------------------------------------------------------------------
# slice 6a: the MoE family (qwen3-moe-30b-a3b, mixtral-8x7b), kernel 1
# batched over the experts
# --------------------------------------------------------------------------

# (model, GEMM, E, M, K, N) of the expert GEMMs the MoE paths launch: a
# decode tick of 4 slots gives M = C = 4; a prefill of 4 x 128 tokens
# (qwen3-moe, top-8 of 128) and of 512 tokens (mixtral, top-2 of 8) gives
# C = int(1.25 x T x K / E) = 40 and 160. The first row is the headline.
MOE_GEMM_SHAPES = (
    ("qwen3-moe", "decode gate/up", 128, 4, 2048, 768),
    ("qwen3-moe", "decode down", 128, 4, 768, 2048),
    ("qwen3-moe", "prefill gate/up", 128, 40, 2048, 768),
    ("qwen3-moe", "prefill down", 128, 40, 768, 2048),
    ("mixtral", "decode gate/up", 8, 4, 4096, 14336),
    ("mixtral", "decode down", 8, 4, 14336, 4096),
    ("mixtral", "prefill gate/up", 8, 160, 4096, 14336),
    ("mixtral", "prefill down", 8, 160, 14336, 4096),
)
# (E, M, K, N) beside them: ragged E, M and N (a partial last tile and
# group), each route with and without a split of K, and the decode route's
# 8- and 16-row instances
MOE_GEMM_EXTRA = ((3, 5, 200, 77), (5, 19, 130, 100), (2, 40, 4096, 128),
                  (3, 4, 4096, 96), (7, 9, 1000, 300), (6, 13, 777, 45),
                  (1, 4, 2048, 768))
# (E, M, K, N) of the stream route's empty-expert cases: qwen3-moe's decode
# down and gate/up (no split of K), mixtral's decode down (K split in two)
# and a ragged stack (split in four)
MOE_EMPTY_SHAPES = ((128, 4, 768, 2048), (128, 4, 2048, 768),
                    (8, 4, 14336, 4096), (7, 9, 1000, 300))
MOE_ARCH = {"qwen3-moe": "qwen3-moe-30b-a3b", "mixtral": "mixtral-8x7b"}
MOE_ARCH_OF = {arch: model for model, arch in MOE_ARCH.items()}
ROUTE_NAMES = {"mma": "mma_bf16", "decode": "decode_f32",
               "stream": "stream_f32"}
# (arch, layers kept, paged drain too) of the MoE serving phases: the
# published widths, depth cut so that the f32 weights fit one card
MOE_SLICES = (("qwen3-moe-30b-a3b", 12, True), ("mixtral-8x7b", 4, False))
MOE_TICK_RUNS = (3, 5)       # runs a side, ticks a run (cold vs warmed)
ROUTE_MARGIN = 1e-5          # the largest top-K probability gap a differing
                             # card/CPU routing choice may have (f32 noise)
MOE_LAYER_RTOL = 0.005       # teacher-forced layer, relative L2


def moe_gemm_operands(E, M, K, N, seed, w_nk):
    """x (E, M, K) and w (E, K, N): contiguous, or the transpose of a
    contiguous (E, N, K) stack where ``w_nk``."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((E, M, K), generator=gen, device=DEV)
    if w_nk:
        w = (torch.randn((E, N, K), generator=gen, device=DEV) /
             math.sqrt(K)).transpose(1, 2)
    else:
        w = torch.randn((E, K, N), generator=gen, device=DEV) / math.sqrt(K)
    return x, w


def per_expert_launches(ops, x, w, policy, plan, quantize_w: bool = True):
    """E single-expert launches of the kernel, one per expert, with the
    batched call's plan (route, split of K, block size): the same
    arithmetic per expert, so the same bits. Called through
    ``ops.launch_gemm_plan``, so they add nothing to the launch counts. A
    transposed x (the dW GEMM's X^T) is copied once, as the wrapper
    copies it."""
    w_nk = not w.is_contiguous()
    wk = w.transpose(1, 2) if w_nk else w
    x = x.contiguous()
    E, M, _ = x.shape
    out = torch.empty((E, M, w.shape[2]), device=DEV)
    for e in range(E):
        ops.launch_gemm_plan(x[e:e + 1], wk[e:e + 1], out[e:e + 1], plan,
                             policy, w_nk, quantize_w)
    return out


def stream_prep_outputs(ops, x, w, policy, plan):
    """One stream-route launch on buffers of its own: the output, and the
    quantized x and live flags its pre-pass wrote (the extension called
    directly, so it adds nothing to the launch counts)."""
    E, M, K = x.shape
    out = torch.empty((E, M, w.shape[2]), device=DEV)
    ws = out if plan.splits == 1 else torch.empty((plan.splits,) + out.shape,
                                                  device=DEV)
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    xq = torch.empty((E, -(-K // ops.GEMM_BK) * ops.GEMM_BK, mt), device=DEV)
    live = torch.empty((E * plan.splits + 1,), dtype=torch.int32, device=DEV)
    ops.extension().mirage_gemm_stream(
        x, w, out, ws, xq, live, policy.g, policy.b_m, False, plan.splits,
        plan.k_split, plan.stages, plan.blocks)
    return out, xq, live[:-1]


def flushed_kernel_ms(fn, n: int = 10):
    """Device time by kernel (torch.profiler) of one call of ``fn``, over
    ``n`` calls with the L2 cache flushed before each (the flush's own
    fill kernel left out)."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    def run():
        scratch.zero_()
        fn()
    prof = device_profile(run, n)
    flush = device_profile(scratch.zero_, n)["top_device_ms"]
    return {k: v for k, v in prof["top_device_ms"].items() if k not in flush}


def routed_operand(x, top_k: int, seed: int):
    """``x`` (E, M, K) with every row zeroed that a decode tick of SLOTS
    tokens leaves empty: the tokens routed top-``top_k`` over the E experts
    by a random router (``moe.route``, capacity M), each kept (token, slot)
    pair filling its row of its expert's buffer. Returns the routed x and
    the number of experts with a nonzero row."""
    import types

    from repro_torch.models import moe

    E, M, _ = x.shape
    gen = torch.Generator(device=DEV).manual_seed(seed)
    router = types.SimpleNamespace(w=torch.randn((64, E), generator=gen,
                                                 device=DEV))
    r = moe.route(router, torch.randn((SLOTS, 64), generator=gen,
                                      device=DEV), top_k, M)
    filled = torch.zeros(E * M + 1, dtype=torch.bool, device=DEV)
    filled[r.slot_index] = True
    mask = filled[:E * M].view(E, M)
    return x * mask[..., None], int(mask.any(dim=1).sum())


def phase_gemm_batched(ops, ref, policy):
    """Kernel 1 over a stack of E experts in one launch, at every expert
    GEMM shape of the MoE paths, in both weight layouts, and at ragged
    shapes covering each route with and without a split of K: bitwise equal
    to E single-expert launches of the route and split its plan picked and
    to a second batched launch, within the f32-order bound of the plain
    version (the cuBLAS product of the folded operands sums in another
    order). The stream route's empty experts: at 0, 75 and 100% of them
    with a zero x, with and without a split of K, their rows exactly +0.0,
    the live rows equal to a launch over the live experts alone, and the
    pre-pass's quantized x and flags equal to its plain version. Then the
    table's shapes timed beside the plain version and ``torch.bmm`` on the
    folded operands, and, at decode, today's decode route on the same
    operands and the stream route on a routed tick's stacks."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cases = [(E, M, K, N, nk, f"{model} {gemm}")
             for model, gemm, E, M, K, N in MOE_GEMM_SHAPES
             for nk in (False, True)]
    cases += [(E, M, K, N, nk, "ragged") for E, M, K, N in MOE_GEMM_EXTRA
              for nk in (False, True)]
    worst, plans = 0.0, set()
    sms = ops.sm_count(torch.device(DEV))

    def tolerance(x, w):
        return 1e-5 * (ref.bfp_fake_quant_ref(x, 4, 16).abs() @
                       ref.bfp_fake_quant_ref(w.transpose(1, 2), 4,
                                              16).transpose(1, 2).abs()) \
            + 1e-30

    def same_bits(a, b):
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    for i, (E, M, K, N, w_nk, what) in enumerate(cases):
        x, w = moe_gemm_operands(E, M, K, N, seed=100 + i, w_nk=w_nk)
        plan = ops.gemm_plan(M, N, K, policy.b_m, sms, True, E, w_nk)
        got = ops.mirage_matmul_fused(x, w, policy)
        again = ops.mirage_matmul_fused(x, w, policy)
        single = per_expert_launches(ops, x, w, policy, plan)
        want = ref.mirage_gemm_ref(x, w, policy.b_m, policy.g)
        tol = tolerance(x, w)
        err = (got - want).abs()
        bad = int((err > tol).sum())
        same, per_expert = same_bits(got, again), same_bits(got, single)
        torch.cuda.synchronize()
        plans.add((plan.route, plan.splits > 1))
        emit({"phase": "gemm_batched_vs_plain", "what": what, "E": E,
              "M": M, "K": K, "N": N, "w_layout": "NK" if w_nk else "KN",
              "route": ROUTE_NAMES[plan.route], "threads": plan.threads,
              "splits": plan.splits, "k_split": plan.k_split,
              "blocks": plan.blocks, "max_abs_err": float(err.max()),
              "max_err_over_tol": float((err / tol).max()),
              "bitwise_vs_per_expert_launches": per_expert,
              "bitwise_repeatable": same,
              "ok": bad == 0 and same and per_expert})
        check(bad == 0, f"batched GEMM outside the bound in {bad} elements "
                        f"at E={E} M={M} K={K} N={N} w_nk={w_nk}")
        check(same, f"two batched launches differ at E={E} M={M} K={K} "
                    f"N={N} w_nk={w_nk}")
        check(per_expert, f"the batched GEMM differs from E single-expert "
                          f"launches at E={E} M={M} K={K} N={N} "
                          f"w_nk={w_nk}")
        worst = max(worst, float(err.max()))
        del x, w, got, again, single, want, tol, err
    want_plans = {(r, s) for r in ("mma", "decode", "stream")
                  for s in (False, True)}
    check(plans == want_plans,
          f"the batched cases cover the plans {sorted(plans)}, not every "
          f"route with and without a split of K")
    n_empty = 0
    for i, ((E, M, K, N), share) in enumerate(
            (shape, share) for shape in MOE_EMPTY_SHAPES
            for share in (0.0, 0.75, 1.0)):
        x, w = moe_gemm_operands(E, M, K, N, seed=300 + i, w_nk=False)
        dead = torch.randperm(E, generator=torch.Generator().manual_seed(
            i))[:round(share * E)].to(DEV)
        x[dead] = 0.0
        live_e = torch.ones(E, dtype=torch.bool, device=DEV)
        live_e[dead] = False
        plan = ops.gemm_plan(M, N, K, policy.b_m, sms, True, E)
        got = ops.mirage_matmul_fused(x, w, policy)
        out, xq, live = stream_prep_outputs(ops, x, w, policy, plan)
        want_xq, want_live = ref.stream_prep_ref(x, policy.b_m, policy.g,
                                                 policy.rounding,
                                                 plan.splits, plan.k_split)
        alone = torch.empty((int(live_e.sum()), M, N), device=DEV)
        if alone.numel():
            ops.launch_gemm_plan(x[live_e].contiguous(),
                                 w[live_e].contiguous(), alone, plan, policy)
        err = (got - ref.mirage_gemm_ref(x, w, policy.b_m, policy.g)).abs()
        bad = int((err > tolerance(x, w)).sum())
        zeros = not got[~live_e].view(torch.int32).any()
        row = {"phase": "gemm_batched_empty_experts", "E": E, "M": M,
               "K": K, "N": N, "empty_share": share,
               "empty_experts": int((~live_e).sum()),
               "route": ROUTE_NAMES[plan.route], "splits": plan.splits,
               "empty_rows_exact_zero": zeros,
               "live_rows_equal_live_alone": same_bits(got[live_e], alone),
               "bitwise_repeatable": same_bits(got, out),
               "prep_xq_equals_plain": same_bits(xq, want_xq),
               "prep_flags_equal_plain": bool(torch.equal(live, want_live)),
               "max_abs_err": float(err.max()), "outside_bound": bad}
        row["ok"] = plan.route == "stream" and bad == 0 and all(
            v for k, v in row.items() if k.startswith(
                ("empty_rows", "live_rows", "bitwise", "prep_")))
        emit(row)
        check(row["ok"], f"stream route with empty experts: {row}")
        n_empty += 1
        del x, w, got, out, xq, alone, err
    rows = []
    for model, gemm, E, M, K, N in MOE_GEMM_SHAPES:
        x, w = moe_gemm_operands(E, M, K, N, seed=1, w_nk=False)
        xq = ref.bfp_fake_quant_ref(x, policy.b_m, policy.g)
        wq = ref.bfp_fake_quant_ref(w.transpose(1, 2), policy.b_m,
                                    policy.g).transpose(1, 2).contiguous()
        plan = ops.gemm_plan(M, N, K, policy.b_m, sms, True, E)
        t_b, by = bound_rate(4.0 * E * (M * K + K * N + M * N),
                             2.0 * E * M * N * K,
                             BF16_FLOPS_PER_S if plan.mma
                             else F32_FLOPS_PER_S)
        row = {"model": model, "gemm": gemm, "E": E, "M": M, "K": K,
               "N": N, "route": ROUTE_NAMES[plan.route],
               "splits": plan.splits,
               "ms": time_ms(lambda: ops.mirage_matmul_fused(x, w, policy)),
               "plain_ms": time_ms(lambda: ref.mirage_gemm_ref(
                   x, w, policy.b_m, policy.g), **PLAIN_TIMING),
               "library_ms": time_ms(lambda: torch.bmm(xq, wq)),
               "library": "torch.bmm on the folded operands",
               "bound_ms": t_b, "bound_by": by}
        if plan.route == "stream":
            # device time by kernel, the L2 flushed before each call: the
            # stream kernel, its pre-pass and reduction against the
            # library's kernel
            row["device_ms_by_kernel"] = flushed_kernel_ms(
                lambda: ops.mirage_matmul_fused(x, w, policy))
            row["library_device_ms_by_kernel"] = flushed_kernel_ms(
                lambda: torch.bmm(xq, wq))
            # today's decode route on the same operands (the plan a stack
            # whose base is not 16-byte aligned takes), and a routed tick
            old = ops.gemm_plan(M, N, K, policy.b_m, sms, True, E,
                                aligned=False)
            out = torch.empty((E, M, N), device=DEV)
            row["decode_route_ms"] = time_ms(lambda: ops.launch_gemm_plan(
                x, w, out, old, policy))
            top_k = get_config(MOE_ARCH[model]).experts_per_token
            xr, n_live = routed_operand(x, top_k, seed=2)
            row["routed_live_experts"] = n_live
            row["routed_ms"] = time_ms(
                lambda: ops.mirage_matmul_fused(xr, w, policy))
            row["routed_bound_ms"] = bound_rate(
                4.0 * (E * M * K + n_live * K * N + E * M * N),
                2.0 * n_live * M * N * K, F32_FLOPS_PER_S)[0]
            del out, xr
        rows.append(row)
        emit({"phase": "timing", "kernel": "mirage_gemm_batched", **row})
        del x, w, xq, wq
    emit({"phase": "gemm_batched_summary", "cases": len(cases),
          "empty_expert_cases": n_empty, "plans": sorted(plans),
          "max_abs_err": worst,
          "phase_seconds": time.perf_counter() - t_phase})
    return worst, rows


class RoutingTap:
    """Records every ``moe.route`` call (its input and result) while open;
    the function and its result are unchanged."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.inner = self.moe.route

        def tapped(router, xf, K, C):
            r = self.inner(router, xf, K, C)
            self.calls.append((xf, r))
            return r

        self.moe.route = tapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.inner


class StreamStackTap:
    """Counts, while open, the expert stacks that take kernel 1's stream
    route: each ``moe_apply`` call runs three stacks of C rows, on that
    route where C <= 16 (``moe.capacity`` is called once a call)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.stacks = moe, 0

    def __enter__(self):
        self.inner = self.moe.capacity

        def tapped(*args, **kw):
            C = self.inner(*args, **kw)
            self.stacks += 3 if C <= 16 else 0
            return C

        self.moe.capacity = tapped
        return self

    def __exit__(self, *exc):
        self.moe.capacity = self.inner


def route_margins(probs, ids_a, ids_b):
    """The (token, slot) choices where ``ids_a`` and ``ids_b`` differ, and
    for each the gap between the two experts' probabilities in ``probs``."""
    diff = (ids_a != ids_b).nonzero().tolist()
    return [abs(float(probs[t, ids_a[t, j]]) - float(probs[t, ids_b[t, j]]))
            for t, j in diff]


def moe_layers_vs_cpu(model, prompt_np, layers):
    """Teacher-forced MoE layers, the card against the CPU's plain path:
    each listed layer gets the card's input on both sides, only its weights
    copied to the host, gridded on the card (:func:`layer_shell`). Beside
    each layer's relative L2: the (token, slot) routing choices
    that differ, (a) on the same router input (the card's, so only the
    router matmul's f32 order differs) with each one's top-K probability
    gap, and (b) on each side's own input to the router."""
    from repro_torch.models import common, moe

    cfg = model.cfg
    L = len(prompt_np)
    prompt = torch.from_numpy(prompt_np[None].astype(np.int64)).to(DEV)
    K = cfg.experts_per_token
    C = moe.capacity(L, cfg.n_experts, K, cfg.capacity_factor)
    t0 = time.perf_counter()
    rows = {}
    with torch.inference_mode():
        pos_d, pos_h = torch.arange(L, device=DEV), torch.arange(L)
        h = common.embed(model.embed, prompt)
        for li, layer_d in enumerate(model.layers):
            with RoutingTap() as tap_d:
                out_d, _, _ = model._attn_mlp_block(layer_d, h, pos_d)
            if li in layers:
                shell = layer_shell(model, li, gridded=True)
                with RoutingTap() as tap_h:
                    out_h, _, _ = shell._attn_mlp_block(
                        shell.layers[0], h.cpu(), pos_h)
                (xf_d, r_d), = tap_d.calls
                (_, r_h), = tap_h.calls
                same_in = moe.route(shell.layers[0].moe.router, xf_d.cpu(),
                                    K, C)
                ids_d = r_d.expert_ids.cpu()
                margins = route_margins(same_in.probs, ids_d,
                                        same_in.expert_ids)
                top = torch.sort(same_in.probs, dim=-1, descending=True)[0]
                rows[f"layer_{li}"] = {
                    "rel_l2": rel_l2(out_d.cpu(), out_h),
                    "routing_diff_same_input": len(margins),
                    "routing_diff_margins": margins,
                    "routing_diff_own_inputs": int(
                        (ids_d != r_h.expert_ids).sum()),
                    "min_topk_margin": float(
                        (top[:, K - 1] - top[:, K]).min()),
                    "dropped_pairs": int((~r_d.keep).sum()),
                    "dropped_pairs_cpu": int((~r_h.keep).sum())}
                del shell
            h = out_d
    ok = all(r["rel_l2"] < MOE_LAYER_RTOL and
             all(m < ROUTE_MARGIN for m in r["routing_diff_margins"])
             for r in rows.values())
    emit({"phase": "moe_vs_cpu_plain", "arch": cfg.arch_id,
          "prompt_len": L, "capacity": C, "layers": rows,
          "rel_l2_limit": MOE_LAYER_RTOL,
          "routing_margin_limit": ROUTE_MARGIN,
          "cpu_seconds": time.perf_counter() - t0, "ok": ok})
    check(ok, f"{cfg.arch_id}: a teacher-forced MoE layer differs from the "
              f"CPU by >= {MOE_LAYER_RTOL} relative L2, or a routing choice "
              f"differs where its top-K gap is >= {ROUTE_MARGIN}: {rows}")


def phase_slice_moe(ops, arch: str, n_layers: int, paged: bool):
    """An MoE config at its published widths, cut to ``n_layers``, served
    under mirage through the port's engine: the slice's requests through
    the cold dense engine, a warmed one (the tick a CUDA graph) and, where
    ``paged``, the paged engine at block size 4, each with the cold dense
    streams token for token; every expert GEMM stack is one launch of
    kernel 1 (7 launches a layer and the head per model step). Then the
    steady tick cold against warmed, each one profiled, and layer 0
    teacher-forced against the CPU. The model is freed after."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions
    from repro_torch.runtime.server import LMServer, Request

    t_phase = time.perf_counter()
    cfg = get_config(arch).reduced() if REDUCED else get_config(arch)
    n_layers = min(n_layers, cfg.n_layers)
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, get_policy("mirage"),
                        LMCallOptions(use_flash_kernel=True), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    n_params = sum(p.numel() for p in model.parameters())
    per_step = 7 * n_layers + 1
    reqs = make_requests(Request, cfg.vocab_size)
    # a short warm-up drain (cuBLAS handles, the allocator); not counted
    warm = LMServer(model, cap=CAP, batch_slots=SLOTS)
    for r in make_requests(Request, cfg.vocab_size, max_tokens=2)[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm
    engines = [("dense_cold", {}, None), ("dense_warmed", {}, "warm")]
    if paged:
        engines.append(("paged", dict(cache_layout="paged",
                                      block_size=PAGED_BS), None))
    rows, streams, launches_by = {}, {}, {}
    for name, kw, prep in engines:
        info = {}
        reqs = make_requests(Request, cfg.vocab_size)
        with StreamStackTap() as tap:
            server, finished, dt, launches, program_s = serve_run(
                ops, model, CAP, reqs, LMServer,
                prepare=warmed(info) if prep else None, **kw)
        m = server.metrics
        # the stream route's pre-pass runs once a stack of C <= 16 rows:
        # counted on the cold drain (every step eager); the warmed and
        # paged engines run the same model steps on the same shapes
        if name == "dense_cold":
            cold_steps, cold_stream = model_steps(m), tap.stacks
        check(model_steps(m) == cold_steps,
              f"slice_moe {arch} {name}: {model_steps(m)} model steps, "
              f"the cold dense drain ran {cold_steps}")
        want = {"mirage_gemm": per_step * model_steps(m),
                "gemm_stream_prep": cold_stream,
                "flash_attention": n_layers * m["prefill_batches"]}
        streams[name] = {r.rid: r.tokens_out for r in finished}
        rows[name] = {**serve_summary(server, finished, dt, launches,
                                      program_s),
                      "model_steps": model_steps(m),
                      "expected_launches": want}
        if prep:
            rows[name]["warmup"] = info
        launches_by[name] = launches
        check(len(finished) == N_REQUESTS and all(
            len(r.tokens_out) == MAX_TOKENS for r in finished),
            f"slice_moe {arch} {name}: not every request completed with "
            f"its budget")
        check(all(0 <= t < cfg.vocab_size for r in finished
                  for t in r.tokens_out),
              f"slice_moe {arch} {name}: a token lies outside the vocabulary")
        expect_launches(launches, want, f"slice_moe {arch} {name}")
        check(streams[name] == streams["dense_cold"],
              f"slice_moe {arch} {name}: the streams differ from the cold "
              f"dense engine's")
        # the metrics' gauges close a cycle back to the engine (and its
        # model): drop both, so that the model is freed below
        del server, m
    # the steady tick, cold against warmed in turns, then each profiled
    runs, n_ticks = MOE_TICK_RUNS
    eng = {"cold": LMServer(model, cap=CAP, batch_slots=SLOTS),
           "warmed": LMServer(model, cap=CAP, batch_slots=SLOTS)}
    eng["warmed"].warmup()
    ticks = {"cold": [], "warmed": []}
    for order in (("cold", "warmed"), ("warmed", "cold")) * (runs // 2) + \
            ((("cold", "warmed"),) if runs % 2 else ()):
        for side in order:
            ticks[side].append(engine_tick_ms(eng[side], reqs, n_ticks))
    med = {k: statistics.median(v) for k, v in ticks.items()}
    profile = {}
    for side, server in eng.items():
        prof = engine_tick_profile(server, reqs)
        profile[side] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "device_kernels", "graph_launches", "top_device_ms",
            "port_kernels_ms")}
        # the expert stacks' kernels: the stream route and its pre-pass
        stacks = sum(v for k, v in prof["port_kernels_ms"].items()
                     if "gemm_stream_kernel" in k or
                     "stream_prep_kernel" in k)
        profile[side]["expert_stacks_ms"] = stacks
        profile[side]["expert_stacks_share_of_busy"] = \
            stacks / prof["device_busy_ms"]
    check(profile["warmed"]["graph_launches"] == 1,
          f"slice_moe {arch}: the warmed tick's profile shows "
          f"{profile['warmed']['graph_launches']} graph launches, expected 1")
    del eng, server
    expert_gb = sum(getattr(layer.moe, k).numel() for layer in model.layers
                    for k in ("gate", "up", "down")) * 4 / 1e9
    emit({"phase": "slice_moe" if arch.startswith("qwen3")
          else "slice_moe_mixtral", "arch": arch, "params": n_params,
          "f32_gb": n_params * 4 / 1e9, "expert_weights_gb": expert_gb,
          "n_layers": n_layers, "d_model": cfg.d_model,
          "n_experts": cfg.n_experts, "top_k": cfg.experts_per_token,
          "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)", "slots": SLOTS,
          "cap": CAP, "gemm_per_step": per_step, **rows,
          "streams_equal_cold_dense": {k: v == streams["dense_cold"]
                                       for k, v in streams.items()},
          "tick_ms": ticks, "tick_ms_median": med,
          "warmed_over_cold_tick": med["warmed"] / med["cold"],
          "ticks_per_run": n_ticks, "tick_profile": profile,
          # every weight but the embedding (a row lookup), read once a tick
          "tick_bound_ms": (n_params - model.embed.emb.numel()) * 4.0 /
          HBM_BYTES_PER_S * 1e3,
          "build_model_s": build_s})
    # layer 0 only: the CPU's plain layer is most of the phase (mixtral's
    # two took 24-68 s)
    moe_layers_vs_cpu(model, reqs[0].prompt, (0,))
    del model
    free_card()
    emit({"phase": f"{arch}_seconds",
          "phase_seconds": time.perf_counter() - t_phase})
    return launches_by


# --------------------------------------------------------------------------
# phases 22-26: slice 6b, training the MoE family on the card
# --------------------------------------------------------------------------

#: (arch, layers kept, steps) of the MoE training slices: the published
#: widths, depth cut so that the f32 train state (masters, gradients and
#: both Adam moments, 16 bytes a parameter) fits one card
MOE_TRAIN_SLICES = (("qwen3-moe-30b-a3b", 4, TRAIN_STEPS),
                    ("mixtral-8x7b", 2, 3))
#: the kinds of expert-stack GEMM a MoE training step launches: dX and dW,
#: and under weight-stationary training the forward and dX, which take
#: the weight as it is
MOE_BWD_KINDS = ("dX", "dW", "fwd_as_is", "dX_as_is")
MOE_GRAD_LAYERS, MOE_FP32_LAYERS = 1, 1
#: the MoE configs trained with weight-stationary quantization and BFP
#: gradient compression, cut to one layer (teacher-forced): the kernels see
#: the same stacks at any depth, the CPU's reference step takes most of the
#: phase's time, and the error-feedback buffer and the bf16 grid copies add
#: about 8 bytes a parameter to the 16 of the plain slices
MOE_WSQ_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")


def moe_train_capacity(cfg) -> int:
    """Rows of an expert buffer at a training step's 256 tokens."""
    from repro_torch.models import moe
    return moe.capacity(TRAIN_BATCH * TRAIN_SEQ, cfg.n_experts,
                        cfg.experts_per_token, cfg.capacity_factor)


def moe_train_stacks():
    """(model, gemm, E, C, K, N, stacks a layer) of the expert stacks of
    both MoE training slices: gate and up (K = d_model, N = moe_d_ff), and
    down (K = moe_d_ff, N = d_model), at C = the capacity of 256 tokens."""
    from repro_torch.configs import get_config
    for model, arch in MOE_ARCH.items():
        cfg = get_config(arch)
        cfg = cfg.reduced() if REDUCED else cfg
        C = moe_train_capacity(cfg)
        yield model, "gate/up", cfg.n_experts, C, cfg.d_model, \
            cfg.moe_d_ff, 2
        yield model, "down", cfg.n_experts, C, cfg.moe_d_ff, cfg.d_model, 1


def moe_bwd_operands(kind: str, E: int, C: int, K: int, N: int, seed: int):
    """Kernel 1's operands (a, b, quantize_w) for one GEMM of a training
    step's expert stack (E, K, N), as ``MirageMatmul`` hands them over: dX
    = dO (E, C, N) @ W^T, the (E, N, K) view of the contiguous stack; dW =
    X^T (E, K, C), the transposed view of the contiguous buffers, @ dO; the
    weight-stationary forward and dX on ``_prequantize_params``' own
    layout (a transposed view of a contiguous (E, N, K) copy on its grid),
    read as it is."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.trainer import _prequantize_params

    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((E, C, K), generator=gen, device=DEV)
    dout = torch.randn((E, C, N), generator=gen, device=DEV) * 1e-2
    w = torch.randn((E, K, N), generator=gen, device=DEV) / math.sqrt(K)
    if kind == "dX":
        return dout, w.transpose(1, 2), True
    if kind == "dW":
        return x.transpose(1, 2), dout, True
    wq = _prequantize_params({"moe.gate": w}, get_policy("mirage"),
                             torch.float32)["moe.gate"].detach()
    check(wq.transpose(1, 2).is_contiguous(), "the weight-stationary stack "
          "is not a transposed view of an (E, N, K) stack")
    return (x, wq, False) if kind == "fwd_as_is" else \
        (dout, wq.transpose(1, 2), False)


def phase_gemm_bwd_batched(ops, ref, policy):
    """Kernel 1 at every expert-stack GEMM of both MoE training slices,
    each one launch over the stack: dX on the (E, N, K) view, dW on X^T
    with the ragged K = C, and the weight-stationary forward and dX on the
    trainer's layout. Bitwise equal to E single-expert launches of the
    plan's route and split and to a repeat, within the f32-order bound of
    the plain version. Then dX and dW timed beside the plain version and
    ``torch.bmm`` on the pre-folded operands."""
    t_phase = time.perf_counter()
    sms = ops.sm_count(torch.device(DEV))
    layers = {MOE_ARCH_OF[arch]: n for arch, n, _ in MOE_TRAIN_SLICES}
    worst, rows, i = 0.0, [], 0
    for model, gemm, E, C, K, N, per_layer in moe_train_stacks():
        for kind in MOE_BWD_KINDS:
            a, b, qw = moe_bwd_operands(kind, E, C, K, N, seed=900 + i)
            i += 1
            w_nk = not b.is_contiguous()
            wk = b.transpose(1, 2) if w_nk else b
            M, Kc, Nout = a.shape[1], a.shape[2], b.shape[2]
            plan = ops.gemm_plan(M, Nout, Kc, policy.b_m, sms, qw, E, w_nk,
                                 wk.data_ptr() % 16 == 0, policy.g)
            got = ops.mirage_matmul_fused(a, b, policy, quantize_w=qw)
            again = ops.mirage_matmul_fused(a, b, policy, quantize_w=qw)
            single = per_expert_launches(ops, a, b, policy, plan, qw)
            want = ref.mirage_gemm_ref(a, b, policy.b_m, policy.g,
                                       quantize_w=qw)
            tol = gemm_bound(ref, a, b, qw)
            err = (got - want).abs()
            bad = int((err > tol).sum())
            same = bool(torch.equal(got.view(torch.int32),
                                    again.view(torch.int32)))
            per_expert = bool(torch.equal(got.view(torch.int32),
                                          single.view(torch.int32)))
            torch.cuda.synchronize()
            emit({"phase": "gemm_bwd_batched_vs_plain", "model": model,
                  "gemm": gemm, "kind": kind, "E": E, "M": M,
                  "contraction": Kc, "N": Nout, "weight_as_is": not qw,
                  "weight_read": weight_read(b[0]),
                  "x_read": "contiguous" if a.is_contiguous() else
                  "transposed view, copied once",
                  "route": ROUTE_NAMES[plan.route], "splits": plan.splits,
                  "max_abs_err": float(err.max()),
                  "max_err_over_tol": float((err / tol).max()),
                  "bitwise_vs_per_expert_launches": per_expert,
                  "bitwise_repeatable": same,
                  "ok": bad == 0 and same and per_expert})
            where = f"{model} {gemm} {kind} E={E} M={M} K={Kc} N={Nout}"
            check(bad == 0, f"batched {where}: {bad} elements outside the "
                            f"bound")
            check(same, f"two batched launches differ at {where}")
            check(per_expert, f"the batched GEMM differs from E "
                              f"single-expert launches at {where}")
            worst = max(worst, float(err.max()))
            del got, again, single, want, tol, err
            if kind in ("dX", "dW"):
                # the library on the pre-folded operands, as for the
                # forward rows
                aq = ref.bfp_fake_quant_ref(a, policy.b_m, policy.g)
                bq = ref.bfp_fake_quant_ref(b.transpose(1, 2), policy.b_m,
                                            policy.g).transpose(1, 2)
                aq, bq = aq.contiguous(), bq.contiguous()
                t_b, by = bound_rate(
                    4.0 * E * (M * Kc + Kc * Nout + M * Nout),
                    2.0 * E * M * Nout * Kc,
                    BF16_FLOPS_PER_S if plan.mma else F32_FLOPS_PER_S)
                row = {"model": model, "gemm": gemm, "kind": kind, "E": E,
                       "M": M, "K": Kc, "N": Nout,
                       "route": ROUTE_NAMES[plan.route],
                       "splits": plan.splits,
                       "launches_per_step": per_layer * layers[model],
                       "ms": time_ms(lambda: ops.mirage_matmul_fused(
                           a, b, policy)),
                       "plain_ms": time_ms(lambda: ref.mirage_gemm_ref(
                           a, b, policy.b_m, policy.g), **PLAIN_TIMING),
                       "library_ms": time_ms(lambda: torch.bmm(aq, bq)),
                       "library": "torch.bmm on the folded operands",
                       "bound_ms": t_b, "bound_by": by}
                rows.append(row)
                emit({"phase": "timing", "kernel": "mirage_gemm_bwd_batched",
                      **row})
                del aq, bq
            del a, b
    emit({"phase": "gemm_bwd_batched_summary", "cases": i,
          "max_abs_err": worst,
          "phase_seconds": time.perf_counter() - t_phase})
    return worst, rows


def active_gemm_weights(model) -> int:
    """Weights one token's GEMMs read: the attention projections and the
    head whole, K / E of each expert stack (its K experts); the routers'
    f32 matmuls are left out."""
    cfg = model.cfg
    total = 0
    for name, p in model.named_parameters():
        if name.endswith(("moe.gate", "moe.up", "moe.down")):
            total += p.numel() * cfg.experts_per_token // cfg.n_experts
        elif name.endswith(".w") and ".router." not in name:
            total += p.numel()
    return total + (model.embed.emb.numel() if cfg.tie_embeddings else 0)


def grad_digest(grads) -> str:
    """A digest of a set of gradients: sha1 over each leaf's int64 sum of
    its f32 bit patterns (summed on the device; a change in any one
    element's bits changes its leaf's sum)."""
    sums = torch.stack([g.view(torch.int32).sum(dtype=torch.int64)
                        for g in grads]).cpu()
    return hashlib.sha1(sums.numpy().tobytes()).hexdigest()


def repeat_step(model, batch):
    """Step 1's loss and gradient digest of ``model`` on ``batch``, twice
    from the same parameters: (losses, digests)."""
    params = list(model.parameters())
    losses, digests = [], []
    for _ in range(2):
        loss, _ = model.loss({k: torch.from_numpy(v).to(DEV)
                              for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.detach())
        digests.append(grad_digest(grads))
        del loss, grads
    return losses, digests


def phase_slice_train_moe(ops, arch: str, n_layers: int, n_steps: int):
    """An MoE config at its published widths, cut to ``n_layers``, trained
    as ``python -m repro_torch.launch.train --arch ARCH --layers N`` trains
    it (batch 4 x 64, AdamW lr 1e-3, clip 1.0, ``mirage``): every forward,
    dX and dW GEMM one launch of kernel 1 (3 x (7 x layers + 1) a step,
    each expert stack one launch), finite losses and grad norms, the step
    time, tokens/s, peak memory and the model-FLOP share over the active
    weights; then 2 steps profiled, the step's parts, and two steps from
    one state, whose losses and gradient digests must be the same bits
    (the dispatch's scatter and the combine's gather accumulate no float
    on a kept row). The model is freed after."""
    from repro_torch.core.precision import get_policy

    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("mirage"), arch, n_layers)
    data = iter(data)
    per_step = 3 * (7 * cfg.n_layers + 1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    state, step, times, logs = run_train(model, tc, data, n_steps)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    times, logs = list(times), list(logs)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    weights = active_gemm_weights(model)
    flops = 6.0 * weights * tokens
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    finite = all(math.isfinite(v) for v in losses + norms)
    want = {"mirage_gemm": per_step * n_steps}
    name = "slice_train_moe" if arch.startswith("qwen3") else \
        "slice_train_moe_mixtral"
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": name, "arch": arch, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_experts": cfg.n_experts,
          "top_k": cfg.experts_per_token, "moe_d_ff": cfg.moe_d_ff,
          "capacity": moe_train_capacity(cfg),
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": n_steps,
          "optimizer": "adamw lr=1e-3 clip=1.0", "params": n_params,
          "train_state_gb": 16.0 * n_params / 1e9,
          "active_gemm_weights": weights, "gemm_per_step": per_step,
          "launches": launches, "expected_launches": want,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_2_on": step_s * 1e3,
          "tok_per_s": tokens / step_s, "peak_mem_gb": peak,
          "allocated_before_gb": before, "build_model_s": build_s,
          "model_flops_per_step": flops,
          "model_flops_share_of_989_tflops": flops / step_s / BF16_FLOPS_PER_S,
          "losses": losses, "grad_norms": norms})
    check(finite, f"{name}: a loss or grad norm is not finite: {losses} "
                  f"{norms}")
    expect_launches(launches, want, name)
    prof = device_profile(lambda: step(state, next(data)), 2, host=False)
    emit({"phase": f"{name}_profile", "steps": 2, **{
        k.replace("_ms", "_ms_per_step"): v for k, v in prof.items()}})
    emit({"phase": f"{name}_breakdown", "steps": 2,
          **step_breakdown(model, tc, state, data, 2)})
    del state
    free_card()
    batch = {k: np.asarray(v) for k, v in next(data).items()}
    losses2, digests = repeat_step(model, batch)
    same = bool(torch.equal(losses2[0].view(torch.int32),
                            losses2[1].view(torch.int32))) and \
        digests[0] == digests[1]
    emit({"phase": f"{name}_repeat", "losses": [float(v) for v in losses2],
          "grad_digests": digests, "bitwise_equal": same, "ok": same,
          "phase_seconds": time.perf_counter() - t_phase})
    check(same, f"{name}: two steps from one state differ: "
                f"{[float(v) for v in losses2]} {digests}")
    del model
    free_card()
    return launches


def phase_train_moe_grads_vs_cpu(ops, ref, arch: str = "qwen3-moe-30b-a3b",
                                 n_layers: int = MOE_GRAD_LAYERS):
    """Mirage at full width is chaotic end to end, so teacher-forced: the
    CPU's (x, w, dO) of every expert stack of ``n_layers`` layers, from
    its step-1 backward, go through the card's batched ``MirageMatmul``;
    its dX and dW must lie within the f32-order bound of the CPU's. The
    routers: the CPU's router input of each layer routed on the card, no
    choice differing unless its top-K gap is under ROUTE_MARGIN. Step 1's
    loss on both sides beside them."""
    from repro_torch.core.precision import get_policy
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    policy = get_policy("mirage")
    cfg, model, tc, data = train_setup(policy, arch, n_layers)
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = data.batch_at(0)
    t0 = time.perf_counter()
    with RoutingTap() as tap:
        cpu_loss, cap, head = cpu_capture(
            cpu_model, batch, range(n_layers), gemms=("gate", "up", "down"),
            with_head=False)
    cpu_s = time.perf_counter() - t0
    K, C = cfg.experts_per_token, moe_train_capacity(cfg)
    routing = {}
    with torch.no_grad():
        card_loss, _ = model.loss({k: torch.from_numpy(v).to(DEV)
                                   for k, v in batch.items()})
        for li, (xf, r_h) in enumerate(tap.calls):
            r_d = moe.route(model.layers[li].moe.router,
                            to_card(xf.detach()), K, C)
            margins = route_margins(r_h.probs.detach(), r_h.expert_ids,
                                    r_d.expert_ids.cpu())
            top = torch.sort(r_h.probs.detach(), dim=-1, descending=True)[0]
            routing[f"layer_{li}"] = {
                "routing_diff_same_input": len(margins),
                "routing_diff_margins": margins,
                "min_topk_margin": float((top[:, K - 1] - top[:, K]).min()),
                "dropped_pairs": int((~r_d.keep).sum()),
                "dropped_pairs_cpu": int((~r_h.keep).sum())}
    card_loss = float(card_loss)
    del model
    free_card()
    rows, bad = teacher_forced(ref, cap, head)
    route_ok = all(m < ROUTE_MARGIN for r in routing.values()
                   for m in r["routing_diff_margins"])
    emit({"phase": "train_moe_grads_vs_cpu", "arch": arch,
          "n_layers": n_layers, "policy": "mirage", "capacity": C,
          "stacks": rows, "routing": routing,
          "routing_margin_limit": ROUTE_MARGIN,
          "step1_loss_card": card_loss, "step1_loss_cpu": cpu_loss,
          "step1_loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
          "cpu_seconds": cpu_s, "ok": not bad and route_ok,
          "phase_seconds": time.perf_counter() - t_phase})
    check(len(rows) == 3 * n_layers, f"train_moe_grads_vs_cpu captured "
                                     f"{len(rows)} expert stacks")
    check(not bad, f"card expert-stack dX/dW outside the GEMM bound of the "
                   f"CPU's at {bad}")
    check(route_ok, f"a routing choice differs on the same router input "
                    f"with a top-K gap >= {ROUTE_MARGIN}: {routing}")


# --------------------------------------------------------------------------
# slice 6c: the MoE family under the RNS/RRNS datapath, kernels 4-6 over
# expert stacks
# --------------------------------------------------------------------------

#: (model, GEMM, E, C, K, N) of the expert stacks the RNS paths hand the
#: residue kernels: a decode tick's C = 4 and the prefill's C = 40 / 160
#: (4 prompts of the 128 bucket), as MOE_GEMM_SHAPES
MOE_RNS_STACKS = (
    ("qwen3-moe", "decode gate/up", 128, 4, 2048, 768),
    ("qwen3-moe", "decode down", 128, 4, 768, 2048),
    ("qwen3-moe", "prefill gate/up", 128, 40, 2048, 768),
    ("mixtral", "decode gate/up", 8, 4, 4096, 14336),
    ("mixtral", "decode down", 8, 4, 14336, 4096),
    ("mixtral", "prefill gate/up", 8, 160, 4096, 14336),
)
#: (arch, layers) of the MoE serving slices under mirage_rrns and
#: mirage_rns (one layer each: the per-call weight encoding made these
#: drains the script's longest phase, and the depth is what the script's
#: time limit can give up), and of the stationary-weight ones: stationary
#: residues take ~20 bytes a weight, so qwen3-moe's 12 layers (~145 GB) do
#: not fit one card
MOE_RNS_SLICES = (("qwen3-moe-30b-a3b", 1), ("mixtral-8x7b", 1))
MOE_STATIONARY_SLICES = (("qwen3-moe-30b-a3b", 1), ("mixtral-8x7b", 1))
MOE_RNS_TRAIN = ("qwen3-moe-30b-a3b", 1, 2)     # arch, layers, steps
MOE_RNS_TICKS = 2             # steady ticks a side, cold then warmed
MOE_RNS_TOKENS = 4            # the mirage_rns drain's tokens a request


def stack_block_operands(moduli, E, G, M, N, seed):
    """Encoded residues (``encoded_residue_operands``) of a whole stack of
    E experts, (n_mod, E x G, M, 16) and (n_mod, E x G, 16, N), and the
    first block the card's plan (``card_blocks``) hands the residue kernel
    at these shapes: its slices, in place, its slot count and its noise
    period (the block's groups)."""
    from repro_torch.core.backends.mirage_rns import card_blocks

    n = len(moduli)
    eb, gb = card_blocks(n, E, G, M, N)
    # one expert past the block, so that a block of whole experts is a
    # slice with its own stride between moduli, as on the path
    E = min(E, eb + 1)
    xr, wr = encoded_residue_operands(moduli, M, 16 * E * G, N, seed)
    xs = xr.view(n, E, G, M, 16)[:, :eb, :gb].reshape(n, -1, M, 16)
    ws = wr.view(n, E, G, 16, N)[:, :eb, :gb].reshape(n, -1, 16, N)
    return xs, ws, eb, gb


def phase_rns_stacks(ops, ref):
    """Kernels 4, 5 and 6 at the expert stacks of the MoE paths, on the
    block the card's plan hands them (qwen3-moe's gate/up at decode is one
    launch of 81,920 slots under RRNS, past grid.z's 65,535; a block of
    whole experts is sliced in place; mixtral's prefill gate/up runs one
    expert's groups a block): kernel 4 over the base moduli, kernel 5 over
    the RRNS moduli with one expert-shaped noise draw read at a group
    period, at 20 dB (every rounding and wrap case) and at the slice's 52
    dB, and kernel 6 on kernel 5's output: each bit for bit against its
    plain version, then timed beside it, ``torch.bmm`` of the residues as
    f32 and the bound."""
    from repro_torch.analog import rrns

    psi = (math.prod(RNS_BASE) - 1) // 2
    tables = rrns.get_tables(RRNS_ALL, len(RNS_BASE), psi)
    rows = {"rns_matmul": [], "rns_matmul_channel": [], "rrns_decode": []}
    for i, (model, name, E, M, K, N) in enumerate(MOE_RNS_STACKS):
        t0 = time.perf_counter()
        G = K // 16
        shape = {"model": model, "gemm": name, "experts": E, "C": M,
                 "K": K, "N": N}
        # kernel 4: mirage_rns
        xr, wr, eb, gb = stack_block_operands(RNS_BASE, E, G, M, N, 600 + i)
        S = S4 = xr.shape[1]
        got = ops.rns_group_matmul(xr, wr, RNS_BASE)
        bad4 = int((got != ref.rns_matmul_ref(xr, wr, RNS_BASE)).sum())
        in_place = not xr.is_contiguous() and not wr.is_contiguous()
        check(bad4 == 0, f"rns_matmul over a stack block differs from its "
                         f"plain version in {bad4} residues at {shape}")
        n3 = len(RNS_BASE)
        row4 = {**shape, "n_mod": n3, "experts_per_block": eb,
                "groups_per_block": gb, "slots": n3 * S,
                "sliced_in_place": in_place}
        xf = xr.reshape(n3 * S, M, 16).float()
        wf = wr.reshape(n3 * S, 16, N).float()
        b4 = 4.0 * (n3 * S * (M * 16 + 16 * N + M * N))
        t_b, by = bound_rate(b4, 2.0 * n3 * S * M * N * 16, INT_OPS_PER_S)
        row4.update({
            "ms": time_ms(lambda: ops.rns_group_matmul(xr, wr, RNS_BASE),
                          n=10),
            "plain_ms": time_ms(lambda: ref.rns_matmul_ref(xr, wr,
                                                           RNS_BASE), **PLAIN_TIMING),
            "library_ms": time_ms(lambda: torch.bmm(xf, wf), n=10),
            "bound_ms": t_b, "bound_by": by})
        rows["rns_matmul"].append(row4)
        del xr, wr, xf, wf, got
        # kernels 5 and 6: mirage_rrns
        xr, wr, eb, gb = stack_block_operands(RRNS_ALL, E, G, M, N, 700 + i)
        n5, S = len(RRNS_ALL), xr.shape[1]
        gen = torch.Generator(device=DEV).manual_seed(800 + i)
        checks = {}
        for snr in (20.0, SNR_DB):
            noise = detector_noise(RRNS_ALL, (gb, M, N), snr, gen)
            res, flips = ops.rns_group_matmul_channel(
                xr, wr, RRNS_ALL, noise, count_flips=True)
            want, want_flips = ref.rns_matmul_channel_ref(
                xr, wr, RRNS_ALL, noise, count_flips=True)
            bad5 = int((res != want).sum())
            del want
            dec, votes = ops.rrns_decode(res, tables)
            want_dec, want_votes = ref.rrns_decode_ref(res, tables)
            bad6 = int((dec != want_dec).sum()) + int(
                (votes.view(torch.int32) != want_votes.view(torch.int32))
                .sum())
            checks[f"{snr:g}dB"] = {
                "channel_mismatches": bad5, "flips": flips.tolist(),
                "flips_equal_plain": flips.tolist() == want_flips.tolist(),
                "decode_mismatches": bad6,
                "uncorrected": int((votes < float(tables.vote_threshold))
                                   .sum())}
            check(bad5 == 0 and flips.tolist() == want_flips.tolist(),
                  f"rns_matmul_channel over a stack block differs from its "
                  f"plain version ({bad5} residues, flips {flips.tolist()} "
                  f"against {want_flips.tolist()}) at {shape}, {snr} dB")
            check(bad6 == 0, f"rrns_decode over a stack block differs from "
                             f"its plain version at {shape}, {snr} dB")
            del dec, votes, want_dec, want_votes
            if snr != SNR_DB:
                del res, noise
        emit({"phase": "rns_stacks_vs_plain", **shape,
              "experts_per_block": eb, "groups_per_block": gb,
              "slots_rrns": n5 * S, "slots_rns": n3 * S4,
              "noise_period": gb, "rns_matmul_mismatches": bad4,
              "sliced_in_place": in_place, "rrns": checks, "ok": True,
              "seconds": time.perf_counter() - t0})
        xf = xr.reshape(n5 * S, M, 16).float()
        wf = wr.reshape(n5 * S, 16, N).float()
        base = {**shape, "n_mod": n5, "experts_per_block": eb,
                "groups_per_block": gb, "slots": n5 * S, "noise_period": gb}
        b5 = 4.0 * (n5 * S * (M * 16 + 16 * N + M * N) + n5 * gb * M * N)
        t_b, by = bound_rate(b5, 2.0 * n5 * S * M * N * 16, INT_OPS_PER_S)
        rows["rns_matmul_channel"].append({
            **base,
            "ms": time_ms(lambda: ops.rns_group_matmul_channel(
                xr, wr, RRNS_ALL, noise), n=10),
            "plain_ms": time_ms(lambda: ref.rns_matmul_channel_ref(
                xr, wr, RRNS_ALL, noise), **PLAIN_TIMING),
            "library_ms": time_ms(lambda: torch.bmm(xf, wf), n=10),
            "bound_ms": t_b, "bound_by": by})
        del xf, wf, xr, wr, noise
        rows["rrns_decode"].append(decode_timing_row(
            ops, ref, res, tables, {**base, "inputs": "path, 52 dB"}))
        del res
        free_card()
    for name, shapes in rows.items():
        for row in shapes:
            emit({"phase": "timing", "kernel": name, "path": "moe_stacks",
                  **row})
    return rows


class BlockTap:
    """Counts, while open, the residue blocks the RNS backends run by
    wrapping ``mirage_rns.run_blocks``: each block is one launch of kernel
    4 or 5 and, under RRNS, one of kernel 6. Also the blocks of expert
    stacks and the most slots one launch took."""

    def __init__(self):
        from repro_torch.core.backends import mirage_rns
        from repro_torch.obs import health
        self.module, self.health = mirage_rns, health
        self.blocks = self.stack_blocks = self.max_slots = 0
        # GEMM calls (one run_blocks each) under an open health scope and
        # inside a suppressed block (the hybrid's shared block), and the
        # residue blocks of the former
        self.counted_calls = self.suppressed_calls = 0
        self.counted_blocks = 0

    def __enter__(self):
        self.inner = inner = self.module.run_blocks

        def tapped(xr, wr, sx, sw, eb, gb, block_fn):
            n_mod, E, G = xr.shape[:3]
            n = -(-E // eb) * -(-G // gb)
            self.blocks += n
            if self.health.active():
                self.counted_calls += 1
                self.counted_blocks += n
            elif self.health._stack():
                self.suppressed_calls += 1
            if E > 1:
                self.stack_blocks += n
            self.max_slots = max(self.max_slots,
                                 n_mod * min(E, eb) * min(G, gb))
            return inner(xr, wr, sx, sw, eb, gb, block_fn)

        self.module.run_blocks = tapped
        return self

    def __exit__(self, *exc):
        self.module.run_blocks = self.inner


def published_model(arch: str, n_layers: int, policy):
    """``arch`` at its published widths (the reduced config in a CPU
    rehearsal) cut to ``n_layers`` (of each stack of an enc-dec model),
    weights from seed 0 on the card, under ``policy``, the prefill
    attention through the flash kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    cfg = get_config(arch).reduced() if REDUCED else get_config(arch)
    cfg = dataclasses.replace(
        cfg, n_layers=min(n_layers, cfg.n_layers),
        encoder_layers=min(n_layers, cfg.encoder_layers))
    return build_model(cfg, policy, LMCallOptions(use_flash_kernel=True),
                       device=DEV,
                       generator=torch.Generator(device=DEV).manual_seed(0))


def moe_rns_drain(ops, model, reqs, **engine_kw):
    """Drain ``reqs`` through a fresh engine, counting the residue blocks:
    (summary, streams, health, launches, blocks, stationary_weights)."""
    from repro_torch.runtime.server import LMServer

    with BlockTap() as tap:
        server, finished, dt, launches, program_s = serve_run(
            ops, model, CAP, reqs, LMServer, **engine_kw)
    summary = serve_summary(server, finished, dt, launches, program_s)
    summary["model_steps"] = model_steps(server.metrics)
    summary["residue_blocks"] = tap.blocks
    summary["stack_blocks"] = tap.stack_blocks
    summary["most_slots_a_launch"] = tap.max_slots
    summary["gemm_calls_health_counted"] = tap.counted_calls
    summary["gemm_calls_health_suppressed"] = tap.suppressed_calls
    summary["residue_blocks_health_counted"] = tap.counted_blocks
    out = (summary, {r.rid: r.tokens_out for r in finished},
           server.health_snapshot(), launches, tap.blocks,
           server.stationary_weights, finished)
    del server
    return out


def check_drain(what, finished, n_req, n_tok, vocab):
    check(len(finished) == n_req and all(
        len(r.tokens_out) == n_tok for r in finished),
        f"{what}: not every request completed with its tokens")
    check(all(0 <= t < vocab for r in finished for t in r.tokens_out),
          f"{what}: a token lies outside the vocabulary")


def phase_slice_moe_rns(ops, arch: str, n_layers: int):
    """An MoE config at its published widths, cut to ``n_layers``, served
    under the paper's datapath with the default engine, which encodes the
    weights per call (the JAX engine's rule for the MoE family): the
    slice's requests under mirage_rrns at 52 dB (kernel 5 and kernel 6 on
    every block of every GEMM, the expert stacks over (n_mod, E x G)
    slots), its clean-channel twin (kernel 4 and kernel 6; the streams must
    be equal and no decode may be beyond the correction radius), the
    steady tick cold against warmed (one CUDA graph), and a short
    mirage_rns drain (kernel 4). Launches are held to the residue blocks
    the backends ran. The model is freed after."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

    t_phase = time.perf_counter()
    noisy = get_policy("mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)
    model = published_model(arch, n_layers, noisy)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    vocab = cfg.vocab_size
    rows = {}
    with DecodedElements(ops) as decoded:
        summary, streams, health, launches, blocks, programmed, fin = \
            moe_rns_drain(ops, model, make_requests(Request, vocab))
    check_drain(f"slice_moe_rrns {arch}", fin, N_REQUESTS, MAX_TOKENS, vocab)
    want = {"rns_matmul_channel": blocks, "rrns_decode": blocks,
            "flash_attention": n_layers * summary["prefill_batches"]}
    expect_launches(launches, want, f"slice_moe_rrns {arch} at 52 dB")
    check(not programmed, f"slice_moe_rrns {arch}: the default engine "
                          f"programmed stationary weights on a MoE model")
    check(health["rrns_uncorrected"] == 0,
          f"slice_moe_rrns {arch}: {health['rrns_uncorrected']} decodes "
          f"beyond the correction radius at {SNR_DB} dB")
    rows["rrns_52db"] = {**summary, "expected_launches": want,
                         "health": health,
                         "decoded_elements": decoded.elements}
    model.policy = get_policy("mirage_rrns", noise_seed=NOISE_SEED)
    c_summary, c_streams, c_health, c_launches, c_blocks, _, c_fin = \
        moe_rns_drain(ops, model, make_requests(Request, vocab))
    check_drain(f"slice_moe_rrns {arch} clean", c_fin, N_REQUESTS,
                MAX_TOKENS, vocab)
    c_want = {"rns_matmul": c_blocks, "rrns_decode": c_blocks,
              "flash_attention": n_layers * c_summary["prefill_batches"]}
    expect_launches(c_launches, c_want, f"slice_moe_rrns {arch}, clean")
    check(c_streams == streams, f"slice_moe_rrns {arch}: the 52 dB greedy "
                                f"streams differ from the clean channel's")
    rows["rrns_clean"] = {**c_summary, "expected_launches": c_want,
                          "health": c_health}
    # the steady tick at 52 dB, cold against warmed (one graph replay)
    model.policy = noisy
    reqs = make_requests(Request, vocab)
    # one prompt bucket: the warmup then runs 3 prefill shapes, not 19
    one_bucket = dict(buckets=(PROMPT_LENS[1],))
    eng = {"cold": LMServer(model, cap=CAP, batch_slots=SLOTS, **one_bucket),
           "warmed": LMServer(model, cap=CAP, batch_slots=SLOTS,
                              **one_bucket)}
    warm_info = eng["warmed"].warmup()
    ticks = {side: engine_tick_ms(eng[side], reqs, MOE_RNS_TICKS)
             for side in ("cold", "warmed")}
    # the warmed tick's device time (a cold tick runs the same kernels)
    prof = engine_tick_profile(eng["warmed"], reqs, 1)
    profile = {k: prof[k] for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "device_kernels",
        "graph_launches", "top_device_ms", "port_kernels_ms")}
    check(profile["graph_launches"] == 1,
          f"slice_moe_rrns {arch}: the warmed tick's profile shows "
          f"{profile['graph_launches']} graph launches, expected 1")
    del eng
    free_card()
    # a short mirage_rns drain
    model.policy = get_policy("mirage_rns")
    r_summary, _, _, r_launches, r_blocks, _, r_fin = moe_rns_drain(
        ops, model, make_requests(Request, vocab,
                                  max_tokens=MOE_RNS_TOKENS)[:RNS_REQUESTS])
    check_drain(f"slice_moe_rns {arch}", r_fin, RNS_REQUESTS,
                MOE_RNS_TOKENS, vocab)
    r_want = {"rns_matmul": r_blocks,
              "flash_attention": n_layers * r_summary["prefill_batches"]}
    expect_launches(r_launches, r_want, f"slice_moe_rns {arch}")
    emit({"phase": "slice_moe_rrns", "arch": arch, "n_layers": n_layers,
          "params": n_params, "d_model": cfg.d_model,
          "n_experts": cfg.n_experts, "top_k": cfg.experts_per_token,
          "moe_d_ff": cfg.moe_d_ff, "vocab": vocab,
          "policy": f"mirage_rrns b_m=4 g=16 k=5 moduli={list(RRNS_ALL)} "
                    f"snr_db={SNR_DB} noise_seed={NOISE_SEED}, weights "
                    f"encoded per call", "slots": SLOTS, **rows,
          "streams_equal_clean": c_streams == streams,
          "tick_ms": ticks, "ticks_per_run": MOE_RNS_TICKS,
          "warmed_over_cold_tick": ticks["warmed"] / ticks["cold"],
          "warmup": warm_info, "warmed_tick_profile": profile,
          "t_phase_s": time.perf_counter() - t_phase})
    emit({"phase": "slice_moe_rns", "arch": arch, "n_layers": n_layers,
          "policy": "mirage_rns b_m=4 g=16 k=5", "slots": SLOTS,
          **r_summary, "expected_launches": r_want})
    del model
    free_card()
    return {"rrns_52db": launches, "rrns_clean": c_launches,
            "rns": r_launches}


def phase_slice_moe_rrns_stationary(ops, arch: str, n_layers: int):
    """``stationary_weights=True`` on an MoE config (every Dense weight
    and expert stack programmed once, the router raw) at 52 dB: the
    slice's requests give the streams of the per-call engine on a clean
    channel, with every decode corrected; the residues' bytes beside."""
    from repro_torch.core import stationary
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    noisy = get_policy("mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)
    model = published_model(arch, n_layers, noisy)
    vocab = model.cfg.vocab_size
    summary, streams, health, launches, blocks, programmed, fin = \
        moe_rns_drain(ops, model, make_requests(Request, vocab),
                      stationary_weights=True)
    check(programmed, f"slice_moe_rrns_stationary {arch}: not programmed")
    check_drain(f"slice_moe_rrns_stationary {arch}", fin, N_REQUESTS,
                MAX_TOKENS, vocab)
    want = {"rns_matmul_channel": blocks, "rrns_decode": blocks,
            "flash_attention": n_layers * summary["prefill_batches"]}
    expect_launches(launches, want, f"slice_moe_rrns_stationary {arch}")
    residue_gb = sum(
        sr.residues.numel() * 4 for _, m in stationary._moe_modules(model)
        for sr in (m.stationary or {}).values()) / 1e9
    model.policy = get_policy("mirage_rrns", noise_seed=NOISE_SEED)
    c_summary, c_streams, _, _, _, _, _ = moe_rns_drain(
        ops, model, make_requests(Request, vocab))
    check(health["rrns_uncorrected"] == 0,
          f"slice_moe_rrns_stationary {arch}: "
          f"{health['rrns_uncorrected']} decodes beyond the radius")
    check(streams == c_streams,
          f"slice_moe_rrns_stationary {arch}: the programmed engine's 52 dB "
          f"streams differ from the per-call clean engine's")
    emit({"phase": "slice_moe_rrns_stationary", "arch": arch,
          "n_layers": n_layers, "stationary_weights": True,
          "expert_stack_residues_gb": residue_gb, **summary,
          "expected_launches": want, "health": health,
          "clean_per_call": c_summary,
          "streams_equal_clean_per_call": streams == c_streams,
          "t_phase_s": time.perf_counter() - t_phase})
    del model
    free_card()
    return launches


def phase_slice_train_moe_rns(ops):
    """``MOE_RNS_TRAIN``: mirage_rns training steps of an MoE config at
    its published widths (``launch.train --arch ... --layers 1 --policy
    mirage_rns``): every forward, dX and dW GEMM through kernel 4, the
    expert stacks' over (3, E x G) slots; losses finite, launches equal
    to the residue blocks, peak memory."""
    from repro_torch.core.precision import get_policy

    arch, n_layers, n_steps = MOE_RNS_TRAIN
    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("mirage_rns"), arch,
                                       n_layers)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with BlockTap() as tap:
        _, _, times, logs = run_train(model, tc, iter(data), n_steps)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in logs]
    want = {"rns_matmul": tap.blocks}
    emit({"phase": "slice_train_moe_rns", "arch": arch,
          "n_layers": cfg.n_layers, "policy": "mirage_rns b_m=4 g=16 k=5",
          "steps": n_steps, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "launches": launches, "expected_launches": want,
          "stack_blocks": tap.stack_blocks,
          "most_slots_a_launch": tap.max_slots,
          "step_ms": [t * 1e3 for t in times],
          "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / times[-1],
          "peak_mem_gb": peak, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in logs],
          "t_phase_s": time.perf_counter() - t_phase})
    check(all(math.isfinite(v) for v in losses),
          f"MoE mirage_rns training: a loss is not finite: {losses}")
    expect_launches(launches, want, "slice_train_moe_rns")
    del model
    free_card()
    return launches


# --------------------------------------------------------------------------
# phases 37-41: slice 6d, command-r's parallel block and the vlm frontend
# --------------------------------------------------------------------------

VLM_ARCH, CR_ARCH = "internvl2-2b", "command-r-plus-104b"
#: internvl2-2b served and trained at 12 of its 24 layers (the script's
#: time limit); command-r-plus-104b at its published widths cut to 4 of 64
#: layers: 50.3 GB of f32 weights (428 GB at full depth)
VLM_LAYERS, CR_LAYERS, CR_FULL_LAYERS = 12, 4, 64
#: the 52 dB drain of internvl2 and its clean twin (requests, tokens each)
VLM_RRNS_REQUESTS, VLM_RRNS_TOKENS = 4, 8
#: the direct vlm prefill: a prompt of this many tokens behind the 256
#: patch positions, then this many decode steps
VLM_PATCH_PROMPT, VLM_PATCH_DECODE = 64, 4
#: the merged parallel projection against the two it replaces, a layer
#: teacher-forced (the gate tests/test_merge_parallel.py holds JAX to)
MERGE_RTOL = 2e-4
#: fp32 grads of one teacher-forced layer, card against CPU
LAYER_GRAD_RTOL = 1e-4
#: kernel 1 at the shapes slice 6d's paths give it, checked against its
#: plain version and timed: (arch, GEMM, M, K, N, weight stored (N, K),
#: launches a model step of that path). internvl2's untied head has an odd
#: N = 92,553, so its (K, N) rows are not 16-byte aligned; its dX in
#: training contracts over K = 92,553 (a ragged last BFP group) on the
#: transposed view of the head's weight
SLICE6D_GEMMS = (
    (VLM_ARCH, "head (decode)", SLOTS, 2048, 92553, False, 1),
    (VLM_ARCH, "gate/up (decode)", SLOTS, 2048, 8192, False, 48),
    (VLM_ARCH, "frontend fc1 (patch prefill)", 256, 1024, 2048, False, 1),
    (VLM_ARCH, "head dX (train)", TRAIN_BATCH * TRAIN_SEQ, 92553, 2048,
     True, 1),
    (CR_ARCH, "q/o (decode)", SLOTS, 12288, 12288, False, 2 * CR_LAYERS),
    (CR_ARCH, "k/v (decode)", SLOTS, 12288, 1024, False, 2 * CR_LAYERS),
    (CR_ARCH, "gate/up (decode)", SLOTS, 12288, 33792, False,
     2 * CR_LAYERS),
    (CR_ARCH, "down (decode)", SLOTS, 33792, 12288, False, CR_LAYERS),
    (CR_ARCH, "head (decode)", SLOTS, 12288, 256000, False, 1),
    (CR_ARCH, "gate/up (prefill)", 512, 12288, 33792, False,
     2 * CR_LAYERS),
    (CR_ARCH, "merged o+down (layer check)", 16, 12288 + 33792, 12288,
     False, 0),
)
#: flash at slice 6d's prefill shapes: (arch, B, L, H, Kv, D); command-r's
#: 96 query heads over 8 kv heads (a GQA group of 12)
SLICE6D_FLASH = ((CR_ARCH, 4, 128, 96, 8, 128),
                 (CR_ARCH, 1, 17, 96, 8, 128),
                 (VLM_ARCH, 4, 128, 16, 8, 128),
                 (VLM_ARCH, 1, 256 + VLM_PATCH_PROMPT, 16, 8, 128))


def gemm_row(ops, ref, policy, M, K, N, w_nk, seed):
    """Kernel 1 at (M, K, N) against its plain version (the f32-order
    bound of phase_gemm), twice bitwise, and timed beside the plain
    version, ``torch.matmul`` on the folded operands and the bound."""
    x, w = gemm_operands(M, K, N, seed=seed, w_nk=w_nk)
    return gemm_ab_row(ops, ref, policy, x, w)


def gemm_ab_row(ops, ref, policy, x, w):
    """:func:`gemm_row` on given operands: ``x`` (M, K) contiguous or a
    transposed view (dW's X^T), ``w`` (K, N) contiguous or the transposed
    view of an (N, K) matrix (read in place)."""
    M, K, N = x.shape[0], x.shape[1], w.shape[1]
    w_nk = not w.is_contiguous()
    got = ops.mirage_matmul_fused(x, w, policy)
    again = ops.mirage_matmul_fused(x, w, policy)
    want = ref.mirage_gemm_ref(x, w, policy.b_m, policy.g)
    xq, wq = folded(ref, x, w, policy)
    tol = 1e-5 * (xq.abs() @ wq.abs()) + 1e-30
    err = (got - want).abs()
    bad = int((err > tol).sum())
    over_tol = float((err / tol).max())
    same = bool(torch.equal(got.view(torch.int32), again.view(torch.int32)))
    del got, again, want, tol
    plan = card_gemm_plan(ops, M, K, N, policy.b_m)
    t_b, by = bound_rate(4.0 * (M * K + K * N + M * N), 2.0 * M * N * K,
                         BF16_FLOPS_PER_S if plan.mma else F32_FLOPS_PER_S)
    row = {"M": M, "K": K, "N": N, "w_layout": "NK" if w_nk else "KN",
           "x_layout": "MK" if x.is_contiguous() else "KM",
           "route": "mma_bf16" if plan.mma else "decode_f32",
           "splits": plan.splits, "threads": plan.threads,
           "x_rows_16b_aligned": K % 4 == 0,
           "w_rows_16b_aligned": (K if w_nk else N) % 4 == 0,
           "max_abs_err": float(err.max()), "max_err_over_tol": over_tol,
           "bitwise_repeatable": same, "bad": bad,
           "ms": time_ms(lambda: ops.mirage_matmul_fused(x, w, policy),
                         n=10),
           "plain_ms": time_ms(lambda: ref.mirage_gemm_ref(
               x, w, policy.b_m, policy.g), **PLAIN_TIMING),
           "library_ms": time_ms(lambda: torch.matmul(xq, wq), n=10),
           "library": "torch.matmul (pre-folded)",
           "bound_ms": t_b, "bound_by": by}
    del x, w, xq, wq, err
    return row


def phase_slice6d_kernels(ops, ref, policy):
    """Kernel 1 and flash attention at the new shapes of slice 6d's paths
    (the odd-N head, the ragged-K dX, command-r's widths and its GQA group
    of 12), each held against its plain version and timed (``timing``
    lines with ``"path": "slice_6d"``). Returns (GEMM rows, flash rows,
    the worst GEMM and flash errors)."""
    gemm_rows, flash_rows = [], []
    worst_gemm = worst_flash = 0.0
    for i, (arch, name, M, K, N, w_nk, per_step) in enumerate(SLICE6D_GEMMS):
        row = {"arch": arch, "gemm": name, "launches_per_step": per_step,
               **gemm_row(ops, ref, policy, M, K, N, w_nk, seed=2300 + i)}
        gemm_rows.append(row)
        emit({"phase": "timing", "kernel": "mirage_gemm",
              "path": "slice_6d", **row})
        check(row["bad"] == 0 and row["bitwise_repeatable"],
              f"slice 6d GEMM {arch} {name}: outside the bound in "
              f"{row['bad']} elements, or not repeatable")
        worst_gemm = max(worst_gemm, row["max_abs_err"])
        free_card()
    for i, (arch, B, L, H, Kv, D) in enumerate(SLICE6D_FLASH):
        row = flash_case_row(ops, ref, arch, B, L, H, Kv, D, 2400 + i,
                             "slice_6d")
        flash_rows.append(row)
        worst_flash = max(worst_flash, row["max_abs_err"])
    return gemm_rows, flash_rows, worst_gemm, worst_flash


def flash_case_row(ops, ref, arch, B, L, H, Kv, D, seed, path,
                   causal: bool = True):
    """Flash attention (no window; causal unless asked otherwise) at (B, L,
    H, Kv, D) against its plain version within rtol = atol = 2e-5, twice
    bitwise, and timed beside the plain version, SDPA's fastest backend
    that takes the call and the bound (a ``timing`` line with ``"path":
    path``)."""
    q, k, v = flash_operands(B, L, H, Kv, D, seed=seed)
    got = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
    same = bool(torch.equal(got.view(torch.int32), again.view(torch.int32)))
    pos = torch.arange(L, device=DEV)
    allowed = pos[:, None] >= pos[None, :] if causal else \
        torch.ones((L, L), dtype=torch.bool, device=DEV)
    pairs = int(allowed.sum())
    moved = 4.0 * (2 * B * L * H * D + 2 * B * L * Kv * D)
    flops = 4.0 * B * H * pairs * D
    t_b, by = bound_rate(moved, 3 * flops, TF32_FLOPS_PER_S)
    lib = sdpa_yardstick(ref, q, k, v, None, allowed, causal)
    row = {"arch": arch, "B": B, "L": L, "H": H, "Kv": Kv, "D": D,
           "causal": causal, "gqa_group": H // Kv, "max_abs_err": err,
           "ok": ok, "bitwise_repeatable": same,
           "ms": time_ms(lambda: ops.flash_attention(q, k, v, causal)),
           "plain_ms": time_ms(lambda: ref.flash_attention_ref(
               q, k, v, causal), **PLAIN_TIMING),
           "library_ms": lib["ms"], "library": lib["name"],
           "bound_ms": t_b, "bound_by": by,
           "bound_unit": "TF32 tensor cores, 3 products (3xTF32)"}
    emit({"phase": "timing", "kernel": "flash_attention", "path": path,
          **row})
    check(ok and same, f"flash kernel outside rtol=atol=2e-5 at {arch} "
                       f"B={B} L={L} H={H} Kv={Kv} D={D} causal={causal}, "
                       f"or not repeatable")
    del q, k, v, got, again, want
    return row


def layer_shell(model, li: int, gridded: bool = False):
    """Layer ``li`` of ``model`` alone, on the CPU: a one-layer model of
    the same arch (a vocabulary of 8, no frontend) holding a copy of it
    (its GEMM weights already on their BFP grid where ``gridded``:
    :func:`gridded_cpu_copy`)."""
    from repro_torch.models import build_model

    cfg = dataclasses.replace(model.cfg, n_layers=1, vocab_size=8,
                              frontend=None, frontend_dim=0,
                              frontend_len=0)
    shell = build_model(cfg, model.policy, model.opt, device=DEV)
    layer = model.layers[li]
    shell.layers[0] = gridded_cpu_copy(layer, model.policy) if gridded \
        else copy.deepcopy(layer)
    shell = shell.to("cpu")
    if gridded:
        shell.policy = model.policy.replace(assume_quantized_weights=True)
    return shell


def gridded_cpu_copy(module, policy):
    """A CPU copy of ``module`` whose GEMM weights (each ``Dense`` but the
    MoE router, and the expert stacks) lie on their BFP grid along K,
    gridded on the card by the quantizer's plain version (no kernel of the
    port, so the reference stays independent of ``bfp.cuh``, which kernels
    1 and 2 share). Under ``assume_quantized_weights`` the CPU's plain
    GEMMs then take them as they are: the product is the one they would
    compute from the raw weights, without the weight-side quantization
    that is most of a full-width layer's CPU time."""
    from repro_torch.core.stationary import MOE_STACKS
    from repro_torch.kernels import ref
    from repro_torch.models.common import Dense
    from repro_torch.models.moe import MoE

    def grid(w):
        q = ref.bfp_fake_quant_ref(torch.movedim(w.detach(), -2, -1),
                                   policy.b_m, policy.g, policy.rounding)
        return torch.movedim(q, -1, -2).cpu()

    out = copy.deepcopy(module).to("cpu")
    with torch.no_grad():
        for (name, mod), (_, twin) in zip(module.named_modules(),
                                          out.named_modules()):
            if isinstance(mod, Dense) and not name.endswith("router"):
                twin.w.copy_(grid(mod.w))
            elif isinstance(mod, MoE):
                for stack in MOE_STACKS:
                    getattr(twin, stack).copy_(grid(getattr(mod, stack)))
    return out


def layer_forward(model, layer, h, pos):
    """One layer of ``model`` over a full sequence: its attention-and-FFN
    block, or the Mamba2 block of the SSM family."""
    if model.kind == "mamba":
        return model._mamba_block(layer, h)
    return model._attn_mlp_block(layer, h, pos)[0]


def dense_layers_vs_cpu(model, prompt_np, layers, head: bool,
                        patches=None):
    """Teacher-forced layers of a dense model, the card against the CPU's
    plain path: each listed layer (and, where ``head``, the final norm and
    the head at the last position) gets the card's input on both sides,
    its weights copied to the host alone. With ``patches`` the sequence
    is led by their projection, as at a vlm prefill. Returns {layer:
    relative L2} and the CPU seconds."""
    from repro_torch.models import common

    L = len(prompt_np)
    prompt = torch.from_numpy(prompt_np[None].astype(np.int64)).to(DEV)
    t0 = time.perf_counter()
    errs = {}
    with torch.inference_mode():
        h, _ = model._embed_inputs(prompt, patches)
        pos_d = torch.arange(h.shape[1], device=DEV)
        for li, layer_d in enumerate(model.layers):
            out_d = layer_forward(model, layer_d, h, pos_d)
            if li in layers:
                shell = layer_shell(model, li, gridded=True)
                out_h = layer_forward(shell, shell.layers[0], h.cpu(),
                                      pos_d.cpu())
                errs[f"layer_{li}"] = rel_l2(out_d.cpu(), out_h)
                del shell
            h = out_d
        if head:
            norm = copy.deepcopy(model.final_norm).to("cpu")
            lm_head = copy.deepcopy(model.lm_head).to("cpu")
            cfg = model.cfg
            last = h[:, -1:]
            plain = common.dense(lm_head, common.norm(
                norm, last.cpu(), cfg.norm_eps, cfg.norm_type), model.policy)
            errs["head"] = rel_l2(model._head(last).cpu(), plain)
    return errs, time.perf_counter() - t0, L


def serve_cold_and_warmed(ops, model, name, per_step, flash_per_batch):
    """The slice's requests through the cold dense engine and a warmed one
    (the tick a CUDA graph): the streams equal, kernel 1 launched
    ``per_step`` times a model step and flash ``flash_per_batch`` times a
    prefill batch (a layer's attention once; 0 for the SSM family); then
    the steady tick, cold against warmed. Returns (rows, cold streams,
    launches by engine)."""
    from repro_torch.runtime.server import LMServer, Request

    vocab = model.cfg.vocab_size
    warm = LMServer(model, cap=CAP, batch_slots=SLOTS)   # not counted
    for r in make_requests(Request, vocab, max_tokens=2)[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm
    rows, streams, launches_by = {}, {}, {}
    for side in ("cold", "warmed"):
        info = {}
        server, finished, dt, launches, program_s = serve_run(
            ops, model, CAP, make_requests(Request, vocab), LMServer,
            prepare=warmed(info) if side == "warmed" else None)
        m = server.metrics
        want = {"mirage_gemm": per_step * model_steps(m),
                "flash_attention": flash_per_batch * m["prefill_batches"]}
        rows[side] = {**serve_summary(server, finished, dt, launches,
                                      program_s),
                      "model_steps": model_steps(m),
                      "expected_launches": want}
        if side == "warmed":
            rows[side]["warmup"] = info
            check(info["graphs"] == 1, f"{name}: no tick graph captured")
        streams[side] = {r.rid: r.tokens_out for r in finished}
        launches_by[side] = launches
        check_drain(f"{name} {side}", finished, N_REQUESTS, MAX_TOKENS,
                    vocab)
        expect_launches(launches, want, f"{name} {side}")
        del server, m
    check(streams["warmed"] == streams["cold"],
          f"{name}: the warmed streams differ from the cold engine's")
    reqs = make_requests(Request, vocab)
    eng = {"cold": LMServer(model, cap=CAP, batch_slots=SLOTS),
           "warmed": LMServer(model, cap=CAP, batch_slots=SLOTS)}
    eng["warmed"].warmup()
    ticks = {side: engine_tick_ms(server, reqs, 4)
             for side, server in eng.items()}
    prof = engine_tick_profile(eng["warmed"], reqs, 2)
    rows["warmed_tick_profile"] = {k: prof[k] for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "device_kernels",
        "graph_launches", "top_device_ms", "port_kernels_ms")}
    del eng
    rows["tick_ms"] = ticks
    return rows, streams["cold"], launches_by


def decode_bound_ms(model):
    """The decode tick's byte bound: every weight a tick reads (the layers
    and the head, not the embedding's row lookup or the frontend), once,
    at the HBM rate."""
    skip = model.embed.emb.numel() + (
        sum(p.numel() for p in model.frontend_proj.parameters())
        if model.frontend_proj is not None else 0)
    n = sum(p.numel() for p in model.parameters()) - skip
    if model.lm_head is None:
        n += model.embed.emb.numel()
    return n * 4.0 / 1e9, n * 4.0 / HBM_BYTES_PER_S * 1e3


def phase_slice_internvl2(ops):
    """internvl2-2b at its published widths cut to VLM_LAYERS (random
    weights from seed 0) served under mirage, text-only as the JAX engine
    serves it: the slice's requests cold and warmed; one direct prefill of
    256 patch positions (their projection: kernel 1 twice) and a prompt,
    and decode steps from its cache; mirage_rrns at 52 dB against its
    clean twin (equal streams, no decode beyond the radius); the first and
    last layers and the head teacher-forced against the CPU."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

    t_phase = time.perf_counter()
    model = published_model(VLM_ARCH, VLM_LAYERS, get_policy("mirage"))
    cfg = model.cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    per_step = 7 * cfg.n_layers + 1
    rows, streams, launches_by = serve_cold_and_warmed(
        ops, model, "slice_internvl2", per_step, cfg.n_layers)

    # the frontend: one prefill led by 256 projected patches
    gen = torch.Generator(device=DEV).manual_seed(5)
    patches = torch.randn((1, cfg.frontend_len, cfg.frontend_dim),
                          generator=gen, device=DEV)
    prompt = make_requests(Request, cfg.vocab_size)[0].prompt[
        :VLM_PATCH_PROMPT]
    toks = torch.from_numpy(prompt[None].astype(np.int64)).to(DEV)
    cap = cfg.frontend_len + len(prompt) + VLM_PATCH_DECODE
    ops.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = model.prefill(toks, cap, extra_embeds=patches)
        out = [int(logits[0, -1].argmax())]
        for _ in range(VLM_PATCH_DECODE):
            logits, cache = model.decode_step(cache, torch.tensor(
                [[out[-1]]], device=DEV))
            out.append(int(logits[0, -1].argmax()))
    torch.cuda.synchronize()
    patch_launches = dict(ops.LAUNCHES)
    patch_want = {"mirage_gemm": 2 + per_step * (1 + VLM_PATCH_DECODE),
                  "flash_attention": cfg.n_layers}
    idx = int(cache["idx"])
    expect_launches(patch_launches, patch_want, "slice_internvl2 patches")
    check(idx == cap and bool(torch.isfinite(logits).all()),
          f"slice_internvl2 patches: idx {idx} (expected {cap}) or "
          f"non-finite logits")
    del cache, logits

    # the paper's datapath: 52 dB against the clean channel, each engine
    # programming every Dense weight once (5 residues of int32 a weight);
    # one engine's encodings are dropped before the next one programs
    from repro_torch.core import stationary
    rrns, rrns_streams = {}, {}
    for name, policy in (("rrns_52db", get_policy(
            "mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)),
            ("rrns_clean", get_policy("mirage_rrns",
                                      noise_seed=NOISE_SEED))):
        model.policy = policy
        reqs = make_requests(Request, cfg.vocab_size,
                             max_tokens=VLM_RRNS_TOKENS)[:VLM_RRNS_REQUESTS]
        summary, streams_r, health_r, launches, blocks, programmed, \
            finished = moe_rns_drain(ops, model, reqs)
        kernel = "rns_matmul_channel" if name == "rrns_52db" \
            else "rns_matmul"
        want = {kernel: blocks, "rrns_decode": blocks,
                "flash_attention": cfg.n_layers * summary["prefill_batches"]}
        rrns[name] = {**summary, "stationary_weights": programmed,
                      "health": health_r, "expected_launches": want}
        rrns_streams[name] = streams_r
        check_drain(f"slice_internvl2 {name}", finished, VLM_RRNS_REQUESTS,
                    VLM_RRNS_TOKENS, cfg.vocab_size)
        expect_launches(launches, want, f"slice_internvl2 {name}")
        check(programmed and blocks >= per_step * summary["model_steps"],
              f"slice_internvl2 {name}: the engine did not program its "
              f"weights, or ran {blocks} residue blocks for "
              f"{summary['model_steps']} model steps")
        launches_by[name] = launches
        stationary.install(model, None)
        free_card()
    health = rrns["rrns_52db"]["health"]
    check(health["rrns_uncorrected"] == 0,
          f"slice_internvl2: {health['rrns_uncorrected']} decodes beyond "
          f"the correction radius at {SNR_DB} dB")
    check(rrns_streams["rrns_52db"] == rrns_streams["rrns_clean"],
          "slice_internvl2: the 52 dB streams differ from the clean "
          "channel's")
    model.policy = get_policy("mirage")
    bound_gb, bound_ms = decode_bound_ms(model)
    emit({"phase": "slice_internvl2", "arch": VLM_ARCH, "params": n_params,
          "f32_gb": n_params * 4 / 1e9, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "vocab": cfg.vocab_size,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)", "slots": SLOTS,
          "cap": CAP, "gemm_per_step": per_step, **rows,
          "patch_prefill": {"patches": cfg.frontend_len,
                            "prompt_len": len(prompt),
                            "decode_steps": VLM_PATCH_DECODE,
                            "tokens": out, "idx": idx,
                            "launches": patch_launches,
                            "expected_launches": patch_want},
          "rrns": rrns, "rrns_streams_equal_clean": True,
          "decode_bound_gb": bound_gb, "decode_bound_ms": bound_ms})
    errs, cpu_s, L = dense_layers_vs_cpu(
        model, make_requests(Request, cfg.vocab_size)[0].prompt[:16],
        (0, cfg.n_layers - 1), head=True)
    ok = max(errs.values()) < 1e-2
    emit({"phase": "internvl2_vs_cpu_plain", "prompt_len": L,
          "rel_l2": errs, "cpu_seconds": cpu_s, "ok": ok})
    check(ok, f"internvl2 card vs CPU: a teacher-forced layer or the head "
              f"differs by >= 1e-2 relative L2: {errs}")
    del model
    free_card()
    emit({"phase": "slice_internvl2_seconds",
          "phase_seconds": time.perf_counter() - t_phase})
    launches_by["patch_prefill"] = patch_launches
    return launches_by


def frontend_layer_grads_vs_cpu(model, batch, li: int = 0):
    """fp32 gradients of the frontend projector and layer ``li`` on the
    card against the CPU's, teacher-forced: both sides take the card's
    token embeddings and hidden input and one seeded upstream gradient of
    the layer's output (layer 0 reads the projected patches, so the
    projector's two GEMMs are inside)."""
    from repro_torch.core.precision import get_policy
    from repro_torch.models import common

    fp32 = get_policy("fp32")
    cpu_layer = copy.deepcopy(model.layers[li]).to("cpu")
    cpu_proj = copy.deepcopy(model.frontend_proj).to("cpu")
    shell = layer_shell(model, li)
    shell.layers[0] = cpu_layer
    shell.frontend_proj = cpu_proj
    shell.policy = fp32
    policy0 = model.policy
    model.policy = fp32
    toks = torch.from_numpy(batch["tokens"]).to(DEV)
    patches = torch.from_numpy(batch["patches"]).to(DEV)
    with torch.no_grad():
        tok_emb = common.embed(model.embed, toks)
    grads = {}
    for side, m, layer, dev in (("card", model, model.layers[li], DEV),
                                ("cpu", shell, cpu_layer, "cpu")):
        proj = m.frontend_proj
        pe = common.dense(proj.fc2, torch.nn.functional.gelu(
            common.dense(proj.fc1, patches.to(dev), fp32),
            approximate="tanh"), fp32)
        h = torch.cat([pe, tok_emb.to(dev)], dim=1)
        pos = torch.arange(h.shape[1], device=dev)
        out, _, _ = m._attn_mlp_block(layer, h, pos)
        gen = torch.Generator(device="cpu").manual_seed(11)
        dout = torch.randn(out.shape, generator=gen).to(dev)
        names = [f"frontend_proj.{n}" for n, _ in proj.named_parameters()] \
            + [f"layers.{li}.{n}" for n, _ in layer.named_parameters()]
        leaves = list(proj.parameters()) + list(layer.parameters())
        g = torch.autograd.grad(out, leaves, dout, allow_unused=True)
        grads[side] = {n: (x.cpu() if x is not None else None)
                       for n, x in zip(names, g)}
    model.policy = policy0
    errs = {n: rel_l2(grads["card"][n], grads["cpu"][n])
            for n, v in grads["cpu"].items() if v is not None and
            float(v.abs().max()) > 0}
    return errs


def phase_slice_train_internvl2(ops):
    """internvl2-2b at full width and VLM_LAYERS trained as ``python -m
    repro_torch.launch.train --arch internvl2-2b --layers`` trains it:
    batch 4 x 64 tokens led by 256 patches from ``with_extras``, AdamW lr
    1e-3, clip 1.0, mirage; every forward, dX and dW GEMM one launch of
    kernel 1 (3 x (7 x layers + 1) + 5 a step: the projector's fc2 three,
    its fc1 two,
    as the patches take no gradient), finite losses; step time, tokens/s, peak memory; two steps from one
    state bitwise equal; the frontend and layer 0's fp32 gradients
    teacher-forced against the CPU."""
    from repro_torch.core.precision import get_policy
    from repro_torch.data.pipeline import with_extras

    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("mirage"), VLM_ARCH,
                                       VLM_LAYERS)
    data = with_extras(data, cfg)
    per_step = 3 * (7 * cfg.n_layers + 1) + 5
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, step, times, logs = run_train(model, tc, data, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    positions = TRAIN_BATCH * (cfg.frontend_len + TRAIN_SEQ)
    text = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    layer_w = sum(m.w.numel() for m in model.layers.modules()
                  if hasattr(m, "w"))
    front_w = sum(p.numel() for p in model.frontend_proj.parameters())
    flops = 6.0 * (layer_w * positions + model.lm_head.w.numel() * text +
                   front_w * TRAIN_BATCH * cfg.frontend_len)
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    finite = all(math.isfinite(v) for v in losses + norms)
    want = {"mirage_gemm": per_step * TRAIN_STEPS}
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": "slice_train_internvl2", "arch": VLM_ARCH,
          "n_layers": cfg.n_layers, "params": n_params,
          "train_state_gb": 16.0 * n_params / 1e9,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "patches": cfg.frontend_len, "positions_per_step": positions,
          "steps": TRAIN_STEPS, "optimizer": "adamw lr=1e-3 clip=1.0",
          "gemm_per_step": per_step, "launches": launches,
          "expected_launches": want,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_2_on": step_s * 1e3,
          "text_tok_per_s": text / step_s,
          "positions_per_s": positions / step_s, "peak_mem_gb": peak,
          "build_model_s": build_s, "model_flops_per_step": flops,
          "model_flops_share_of_989_tflops": flops / step_s /
          BF16_FLOPS_PER_S, "losses": losses, "grad_norms": norms})
    check(finite, f"slice_train_internvl2: a loss or grad norm is not "
                  f"finite: {losses} {norms}")
    expect_launches(launches, want, "slice_train_internvl2")
    prof = device_profile(lambda: step(state, next(data)), 1, host=False)
    emit({"phase": "slice_train_internvl2_profile", "steps": 1, **{
        k.replace("_ms", "_ms_per_step"): v for k, v in prof.items()}})
    emit({"phase": "slice_train_internvl2_breakdown", "steps": 2,
          **step_breakdown(model, tc, state, data, 2)})
    del state
    free_card()
    batch = {k: np.asarray(v) for k, v in next(data).items()}
    losses2, digests = repeat_step(model, batch)
    same = bool(torch.equal(losses2[0].view(torch.int32),
                            losses2[1].view(torch.int32))) and \
        digests[0] == digests[1]
    check(same, f"slice_train_internvl2: two steps from one state differ: "
                f"{[float(v) for v in losses2]} {digests}")
    free_card()
    t0 = time.perf_counter()
    errs = frontend_layer_grads_vs_cpu(model, batch)
    ok = max(errs.values()) < LAYER_GRAD_RTOL
    emit({"phase": "slice_train_internvl2_checks",
          "repeat_losses": [float(v) for v in losses2],
          "repeat_grad_digests": digests, "repeat_bitwise_equal": same,
          "fp32_grads_vs_cpu_rel_l2": errs,
          "fp32_grads_rtol": LAYER_GRAD_RTOL,
          "cpu_seconds": time.perf_counter() - t0, "ok": ok,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok, f"slice_train_internvl2: fp32 gradients of the frontend or "
              f"layer 0 differ from the CPU's by >= {LAYER_GRAD_RTOL} "
              f"relative L2: {errs}")
    del model
    free_card()
    return launches


def phase_slice_command_r(ops):
    """command-r-plus-104b at its published widths, cut to CR_LAYERS of
    64 layers (random weights from seed 0), served under mirage: the
    slice's requests cold and warmed (kernel 1: 7 launches a layer and the
    head a model step; flash with 96 query heads over 8 kv heads); each
    layer's ``merge_parallel_proj`` projection (which, as in the JAX
    package, merges only the full-sequence forward) against the two it
    replaces, teacher-forced on the card (kernel 1 at K = 12,288 +
    33,792); layer 0 teacher-forced against the CPU."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    model = published_model(CR_ARCH, CR_LAYERS, get_policy("mirage"))
    cfg = model.cfg
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    n_params = sum(p.numel() for p in model.parameters())
    per_step = 7 * cfg.n_layers + 1
    rows, _, launches_by = serve_cold_and_warmed(
        ops, model, "slice_command_r", per_step, cfg.n_layers)

    prompt = make_requests(Request, cfg.vocab_size)[0].prompt[:16]
    merge_err = {}
    ops.reset_launch_counts()
    with torch.inference_mode():
        toks = torch.from_numpy(prompt[None].astype(np.int64)).to(DEV)
        h, _ = model._embed_inputs(toks)
        pos = torch.arange(h.shape[1], device=DEV)
        for li, layer in enumerate(model.layers):
            out, _, _ = model._attn_mlp_block(layer, h, pos)
            merged, _, _ = model._attn_mlp_block(layer, h, pos, merge=True)
            merge_err[f"layer_{li}"] = rel_l2(merged, out)
            h = out
    torch.cuda.synchronize()
    merge_launches = dict(ops.LAUNCHES)
    # 7 GEMMs a layer unmerged, 6 merged (o and down become one); the
    # attention twice, through the flash kernel
    expect_launches(merge_launches, {"mirage_gemm": 13 * cfg.n_layers,
                                     "flash_attention": 2 * cfg.n_layers},
                    "slice_command_r merged layers")
    merge_ok = max(merge_err.values()) < MERGE_RTOL
    bound_gb, bound_ms = decode_bound_ms(model)
    emit({"phase": "slice_command_r", "arch": CR_ARCH, "params": n_params,
          "f32_gb": n_params * 4 / 1e9, "n_layers": cfg.n_layers,
          "full_depth_f32_gb": 4.0 * (n_params + (
              CR_FULL_LAYERS - cfg.n_layers) * sum(
                  p.numel() for p in model.layers[0].parameters())) / 1e9,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "rope_theta": cfg.rope_theta,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)", "slots": SLOTS,
          "cap": CAP, "gemm_per_step": per_step, **rows,
          "merged_layers_rel_l2": merge_err, "merge_rtol": MERGE_RTOL,
          "merged_layer_launches": merge_launches,
          "decode_bound_gb": bound_gb, "decode_bound_ms": bound_ms,
          "build_model_s": build_s})
    check(merge_ok, f"slice_command_r: a merged parallel projection differs "
                    f"from the two it replaces by >= {MERGE_RTOL} relative "
                    f"L2: {merge_err}")
    errs, cpu_s, L = dense_layers_vs_cpu(model, prompt, (0,), head=False)
    ok = max(errs.values()) < 1e-2
    emit({"phase": "command_r_vs_cpu_plain", "prompt_len": L,
          "rel_l2": errs, "cpu_seconds": cpu_s, "ok": ok})
    check(ok, f"command-r card vs CPU: teacher-forced layer 0 differs by "
              f">= 1e-2 relative L2: {errs}")
    del model
    free_card()
    emit({"phase": "slice_command_r_seconds",
          "phase_seconds": time.perf_counter() - t_phase})
    return launches_by



# --------------------------------------------------------------------------
# slice 6e: the SSM family (mamba2-2.7b)
# --------------------------------------------------------------------------

MAMBA_ARCH = "mamba2-2.7b"
#: the served and trained depth (16 of the published 64 layers: from PR
#: 25 zamba2 drives a Mamba2 stack at full depth, 54 layers, and the
#: script's time limit asked for the cut), the engines' cut, the RRNS
#: drains' cut (int32 residues of 5 moduli) and the fp32 end-to-end gate's
#: cut
MAMBA_LAYERS, MAMBA_ENGINE_LAYERS = 16, 4
MAMBA_RRNS_LAYERS, MAMBA_FP32_LAYERS = 16, 2
#: the engines' chunked prefill (17-128-token prompts: exact-length final
#: chunks) and speculative depth
MAMBA_CHUNK, MAMBA_SPEC_K = 48, 4
MAMBA_RRNS_REQUESTS, MAMBA_RRNS_TOKENS = 4, 8
#: the teacher-forced tokens decoded after a prefill in the fp32 gate
MAMBA_DECODE_CHECK = 3
MAMBA_FP32_RTOL = 1e-4
#: kernel 1 at mamba2-2.7b's GEMM shapes: (GEMM, kind, M, K, N, launches a
#: model step of its path). in_proj is 2,560 -> 10,576 (N % 64 = 16: a
#: ragged last column tile), out_proj 5,120 -> 2,560, the untied head
#: 2,560 -> 50,280; training runs 256 tokens, dX = dO @ W^T on the
#: weight's (N, K) view read in place, dW = X^T @ dO on X's transposed view
MAMBA_GEMMS = (
    ("in_proj (decode)", "fwd", SLOTS, 2560, 10576, MAMBA_LAYERS),
    ("out_proj (decode)", "fwd", SLOTS, 5120, 2560, MAMBA_LAYERS),
    ("head (decode)", "fwd", SLOTS, 2560, 50280, 1),
    ("in_proj (prefill)", "fwd", 128, 2560, 10576, MAMBA_LAYERS),
    ("out_proj (prefill)", "fwd", 128, 5120, 2560, MAMBA_LAYERS),
    ("in_proj dX (train)", "dX", 256, 2560, 10576, MAMBA_LAYERS),
    ("in_proj dW (train)", "dW", 256, 2560, 10576, MAMBA_LAYERS),
    ("out_proj dX (train)", "dX", 256, 5120, 2560, MAMBA_LAYERS),
    ("out_proj dW (train)", "dW", 256, 5120, 2560, MAMBA_LAYERS),
    ("head dX (train)", "dX", 256, 2560, 50280, 1),
    ("head dW (train)", "dW", 256, 2560, 50280, 1),
)
#: symbols of kernel 1 in a profiler trace
GEMM_SYMBOLS = ("gemm_decode_kernel", "gemm_mma_kernel",
                "splitk_reduce_kernel")


def mamba_gemm_operands(kind: str, M: int, K: int, N: int, seed: int):
    """Kernel 1's operands for one of MAMBA_GEMMS: the forward's x (M, K)
    and contiguous weight (K, N); dX's dO (M, N) and the weight's (N, K)
    view; dW's X^T (K, M view) and dO (M, N)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=DEV)
    w = torch.randn((K, N), generator=gen, device=DEV) / math.sqrt(K)
    if kind == "fwd":
        return x, w
    dout = torch.randn((M, N), generator=gen, device=DEV) * 1e-2
    return (dout, w.T) if kind == "dX" else (x.T, dout)


def phase_slice_mamba2_kernels(ops, ref, policy):
    """Kernel 1 at every new shape of the SSM family's paths: the decode
    tick's in_proj, out_proj and head, a prefill's projections (M = 128)
    and each one's training dX and dW, held against its plain version
    within the f32-order bound, twice bitwise, and timed beside
    ``torch.matmul`` on the pre-folded operands and its bound (``timing``
    lines with ``"path": "slice_6e"``). Returns (rows, worst error)."""
    rows, worst = [], 0.0
    t_phase = time.perf_counter()
    for i, (name, kind, M, K, N, per_step) in enumerate(MAMBA_GEMMS):
        a, b = mamba_gemm_operands(kind, M, K, N, seed=2500 + i)
        row = {"arch": MAMBA_ARCH, "gemm": name, "kind": kind,
               "launches_per_step": per_step,
               **gemm_ab_row(ops, ref, policy, a, b)}
        rows.append(row)
        emit({"phase": "timing", "kernel": "mirage_gemm",
              "path": "slice_6e", **row})
        check(row["bad"] == 0 and row["bitwise_repeatable"],
              f"slice 6e GEMM {name}: outside the bound in {row['bad']} "
              f"elements, or not repeatable")
        worst = max(worst, row["max_abs_err"])
        del a, b
        free_card()
    emit({"phase": "slice_mamba2_kernels", "gemms": len(rows),
          "max_abs_err": worst,
          "phase_seconds": time.perf_counter() - t_phase})
    return rows, worst


def ssm_state_gb(model, slots: int) -> float:
    """Bytes of ``slots`` slots' recurrent state (``ssm`` and ``conv``)."""
    spec = model.cache_spec(slots, CAP, per_slot_idx=True)
    return sum(math.prod(shape) * 4 for k, (shape, _) in spec.items()
               if k in ("ssm", "conv")) / 1e9


def gemm_share(prof) -> float:
    """Kernel 1's device ms in a profile (its decode, tensor-core and
    split-K reduce kernels)."""
    return sum(v for k, v in prof["port_kernels_ms"].items()
               if any(s in k for s in GEMM_SYMBOLS))


def mamba_fp32_vs_cpu(prompt_np, arch: str = MAMBA_ARCH,
                      n_layers: int = MAMBA_FP32_LAYERS):
    """``arch`` (mamba2-2.7b, or the hybrid zamba2-2.7b) at its widths cut
    to ``n_layers`` layers under fp32: the card's forward logits against
    the CPU's plain path on the same weights, end to end; and a prefill of
    all but the last MAMBA_DECODE_CHECK tokens (the hybrid's shared
    attention through the flash kernel on the card), then those tokens
    decoded one at a time (the recurrent step against the chunked scan,
    the shared block's decode attention against its prefill), against the
    forward of the whole prompt, on the card and on the CPU. Returns
    relative L2s."""
    from repro_torch.core.precision import get_policy

    model = published_model(arch, n_layers, get_policy("fp32"))
    n_layers = model.cfg.n_layers
    cpu = copy.deepcopy(model).to("cpu")
    L, n = len(prompt_np), MAMBA_DECODE_CHECK
    out = {}
    with torch.inference_mode():
        for side, m, dev in (("card", model, DEV), ("cpu", cpu, "cpu")):
            toks = torch.from_numpy(prompt_np[None].astype(np.int64)).to(dev)
            full = m.forward(toks)
            _, cache = m.prefill(toks[:, :L - n], CAP)
            for t in range(L - n, L):
                logits, cache = m.decode_step(cache, toks[:, t:t + 1])
            out[side] = (full.cpu(), logits[:, -1].cpu())
    (full_d, dec_d), (full_h, dec_h) = out["card"], out["cpu"]
    del model, cpu
    free_card()
    return {"layers": n_layers, "prompt_len": L,
            "forward_card_vs_cpu": rel_l2(full_d, full_h),
            "decode_vs_prefill_card": rel_l2(dec_d, full_d[:, -1]),
            "decode_vs_prefill_cpu": rel_l2(dec_h, full_h[:, -1]),
            "decode_card_vs_prefill_cpu": rel_l2(dec_d, full_h[:, -1])}


def phase_slice_mamba2(ops):
    """mamba2-2.7b at its published widths cut to MAMBA_LAYERS layers
    (random weights from seed 0) served under mirage: the slice's requests
    (8 of 17-128 prompt tokens, 32 tokens each, 4 slots) cold and warmed
    (the tick a CUDA graph), the streams equal, kernel 1 launched 2 x
    layers + 1 times a model step (prefill batches of one exact length,
    decode ticks), the steady tick cold against warmed and profiled; then
    layers 0 and the last and the head teacher-forced against the CPU
    (``mamba2_vs_cpu_plain``), with the fp32 gates of
    :func:`mamba_fp32_vs_cpu`. Returns the launches by engine."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    model = published_model(MAMBA_ARCH, MAMBA_LAYERS, get_policy("mirage"))
    cfg = model.cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    per_step = 2 * cfg.n_layers + 1
    rows, _, launches_by = serve_cold_and_warmed(
        ops, model, "slice_mamba2", per_step, 0)
    prof = rows["warmed_tick_profile"]
    gemm_ms = gemm_share(prof)
    weights_gb, _ = decode_bound_ms(model)
    state_gb = ssm_state_gb(model, SLOTS)
    # a tick reads every layer and head weight once and reads and writes
    # every slot's recurrent state
    bound_gb = weights_gb + 2 * state_gb
    emit({"phase": "slice_mamba2", "arch": MAMBA_ARCH, "params": n_params,
          "f32_gb": n_params * 4 / 1e9, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "ssm_heads": cfg.ssm_heads, "ssm_headdim": cfg.ssm_headdim,
          "ssm_state": cfg.ssm_state, "vocab": cfg.vocab_size,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)", "slots": SLOTS,
          "cap": CAP, "gemm_per_step": per_step,
          "prefill": "batches of one exact prompt length", **rows,
          "state_gb_4_slots": state_gb,
          "decode_bound_gb": bound_gb,
          "decode_bound_ms": bound_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
          "warmed_tick_gemm_ms": gemm_ms,
          "warmed_tick_gemm_share_of_busy":
              gemm_ms / prof["device_busy_ms"],
          "warmed_tick_ssm_and_glue_ms": prof["device_busy_ms"] - gemm_ms})
    prompt = make_requests(Request, cfg.vocab_size)[0].prompt[:16]
    errs, cpu_s, L = dense_layers_vs_cpu(model, prompt,
                                         (0, cfg.n_layers - 1), head=True)
    del model
    free_card()
    fp32 = mamba_fp32_vs_cpu(prompt)
    ok_layers = max(errs.values()) < 1e-2
    ok_fp32 = max(v for k, v in fp32.items() if k.startswith(
        ("forward", "decode"))) < MAMBA_FP32_RTOL
    emit({"phase": "mamba2_vs_cpu_plain", "prompt_len": L,
          "rel_l2": errs, "cpu_seconds": cpu_s, "layers_rtol": 1e-2,
          "fp32": fp32, "fp32_rtol": MAMBA_FP32_RTOL,
          "ok": ok_layers and ok_fp32,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok_layers, f"mamba2 card vs CPU: a teacher-forced layer or the "
                     f"head differs by >= 1e-2 relative L2: {errs}")
    check(ok_fp32, f"mamba2 under fp32: the card's logits or its decode "
                   f"after prefill differ by >= {MAMBA_FP32_RTOL} relative "
                   f"L2: {fp32}")
    return launches_by


def ssm_per_step(cfg) -> int:
    """Kernel-1 launches of an SSM or hybrid model step: in_proj and
    out_proj a Mamba2 layer, the shared block's 8 GEMMs an application
    (proj, q, k, v, o, gate, up, down) and the head."""
    return 2 * cfg.n_layers + ZAMBA_SHARED_GEMMS * ssm_napp(cfg) + 1


def ssm_napp(cfg) -> int:
    """Applications of the hybrid family's shared block (0 for mamba2)."""
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def mamba_engine_launches(metrics, cfg, k: int) -> dict:
    """Kernel-1 and flash launches of a drain from the engine's own
    counters: :func:`ssm_per_step` a prefill batch, chunk or decode tick,
    and 2 x (k + 1) x layers + 8 x applications + 1 a verify tick (its
    k + 1 tokens run the recurrent step one at a time, the shared block
    and the head once over all of them); flash once an application a
    prefill batch (chunks and verify ticks attend in plain PyTorch)."""
    nl, napp = cfg.n_layers, ssm_napp(cfg)
    want = {"mirage_gemm": ssm_per_step(cfg) * (
        metrics["prefill_batches"] + metrics["prefill_chunks"] +
        metrics["decode_steps"]) + (2 * (k + 1) * nl + ZAMBA_SHARED_GEMMS *
                                    napp + 1) * metrics["spec_ticks"]}
    if napp:
        want["flash_attention"] = napp * metrics["prefill_batches"]
    return want


def phase_ssm_engines(ops, arch: str, n_layers: int, phase: str):
    """An SSM or hybrid config cut to ``n_layers`` through every
    single-device engine under mirage, each against the dense engine's
    streams with its kernel-1 (and flash) launches counted: paged (a pure
    SSM keeps no page pool, no BlockAllocator, the state dense; the
    hybrid pages its shared block's KV), paged with chunked prefill
    (chunks of 48, exact-length final chunks), the prefix flag (inert: no
    hit, the hybrid's pool still built), speculative decoding (spec_k = 4,
    the state rolled back to each slot's accepted token), pipelined
    prefill, the per-slot oracle, a resize 4 -> 2 -> 4 mid-drain (against
    a fixed engine fed the same arrivals; the hybrid's on the paged
    layout, its pool resized with the slots) and switch_backend mirage ->
    mirage_rns -> mirage. Returns the launches by engine.

    The hybrid's chunk steps attend through the plain chunked attention
    over the pages, its verify ticks through the T-token verify attention
    and the per-slot oracle at batch 1, where the dense engine takes the
    flash kernel and the one-token decode attention over 4 slots: other
    f32 orders, which full-width random-weight BFP turns into other
    tokens (PR 17's finding), so under mirage those three engines'
    streams are recorded against the dense engine's, and held to it under
    fp32 (equal, or first differing where the dense logits' top-2 gap is
    under TOP2_GAP). Every other engine's streams equal the dense
    engine's; the stream checks run after the phase's line is
    printed."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import (LMServer, PerSlotLMServer,
                                            Request)

    t_phase = time.perf_counter()
    model = published_model(arch, n_layers, get_policy("mirage"))
    cfg = model.cfg
    nl, vocab, napp = cfg.n_layers, cfg.vocab_size, ssm_napp(cfg)
    per_step = ssm_per_step(cfg)
    rows, launches_by = {}, {}
    paged = dict(cache_layout="paged", block_size=PAGED_BS)
    engines = (("paged", paged),
               ("paged_chunk", dict(paged, prefill_chunk=MAMBA_CHUNK)),
               ("prefix", dict(paged, prefix_cache=True)),
               ("spec", dict(paged, spec_k=MAMBA_SPEC_K)),
               ("pipelined", dict(pipeline_depth=PIPELINE_DEPTH)))
    float_paths = ("paged_chunk", "spec", "oracle") if napp else ()
    differing = []

    def pool_rule(server, kw):
        """A page pool exactly where the family has KV to page and the
        layout is paged; never a shared prefix."""
        want_pool = bool(napp) and kw.get("cache_layout") == "paged"
        return (server.alloc is not None) == want_pool and \
            ("shared_kp" in server.state["cache"]) == want_pool and \
            not server.prefix_cache

    def drain(name, **kw):
        server, finished, dt, launches, program_s = serve_run(
            ops, model, CAP, make_requests(Request, vocab), LMServer, **kw)
        server.close()
        m = server.metrics
        want = mamba_engine_launches(m, cfg, server.spec_k)
        rows[name] = {**serve_summary(server, finished, dt, launches,
                                      program_s),
                      "model_steps": model_steps(m),
                      "prefill_chunks": m["prefill_chunks"],
                      "spec_ticks": m["spec_ticks"],
                      "prefix_hits": m["prefix_hits"],
                      "block_allocator": server.alloc is not None,
                      "expected_launches": want}
        if server.alloc is not None:
            rows[name]["pool"] = pool_summary(server)
        check_drain(f"{phase} {name}", finished, N_REQUESTS, MAX_TOKENS,
                    vocab)
        expect_launches(launches, want, f"{phase} {name}")
        check(pool_rule(server, kw) and m["prefix_hits"] == 0,
              f"{phase} {name}: the engine's page pool does not follow "
              f"the family's rule, or it shared a prefix")
        launches_by[name] = launches
        return server, {r.rid: r.tokens_out for r in finished}

    _, ref_streams = drain("dense")
    for name, kw in engines:
        server, streams = drain(name, **kw)
        rows[name]["streams_equal_dense"] = streams == ref_streams
        rows[name]["tokens_equal_dense"] = token_share(streams, ref_streams)
        if name == "paged_chunk":
            rows[name]["final_chunk_lengths"] = sorted(
                s[1] for s in server._shapes["chunk_last"])
            check(all(s[1] <= MAMBA_CHUNK for s in
                      server._shapes["chunk_last"]),
                  f"{phase} paged_chunk: a final chunk was padded")
        if name == "spec":
            m = server.metrics
            rows[name]["accepted_per_slot_tick"] = \
                m["spec_accepted"] / max(m["spec_slot_ticks"], 1)
            # the verify step's per-token states against the live state
            rows[name]["verify_states_gb"] = \
                (MAMBA_SPEC_K + 1) * ssm_state_gb(model, SLOTS)
            rows[name]["state_gb"] = ssm_state_gb(model, SLOTS)
        del server
        if streams != ref_streams and name not in float_paths:
            differing.append(name)
    # the per-slot oracle: one prefill a request, one decode a token
    oracle = PerSlotLMServer(model, cap=CAP, batch_slots=SLOTS)
    ops.reset_launch_counts()
    reqs = make_requests(Request, vocab)
    for r in reqs:
        oracle.submit(r)
    finished = oracle.run_until_drained()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    steps = sum(len(r.tokens_out) for r in finished)
    want = {"mirage_gemm": per_step * steps}
    if napp:
        want["flash_attention"] = napp * len(reqs)
    streams = {r.rid: r.tokens_out for r in finished}
    rows["oracle"] = {"launches": launches, "expected_launches": want,
                      "model_steps": steps,
                      "streams_equal_dense": streams == ref_streams,
                      "tokens_equal_dense": token_share(streams,
                                                        ref_streams)}
    expect_launches(launches, want, f"{phase} oracle")
    if streams != ref_streams and "oracle" not in float_paths:
        differing.append("oracle")
    launches_by["oracle"] = launches
    del oracle
    if float_paths:
        # the float-path engines under fp32, against the fp32 dense engine
        model.policy = get_policy("fp32")
        fp32 = {}
        for name, kw in (("dense", {}),) + tuple(
                e for e in engines if e[0] in float_paths):
            server = LMServer(model, cap=CAP, batch_slots=SLOTS, **kw)
            fp32[name] = serve_streams(server, make_requests(Request,
                                                             vocab))
            server.close()
            del server
        fp32["oracle"] = serve_streams(
            PerSlotLMServer(model, cap=CAP, batch_slots=SLOTS),
            make_requests(Request, vocab))
        prompts = {r.rid: r.prompt for r in make_requests(Request, vocab)}
        for name in float_paths:
            firsts = first_differences(model, fp32["dense"], fp32[name],
                                       prompts)
            rows[name]["fp32"] = {
                "tokens_equal_dense": token_share(fp32[name],
                                                  fp32["dense"]),
                "first_differences": firsts}
            if any(f["dense_top2_gap"] >= TOP2_GAP for f in firsts):
                differing.append(f"{name} (fp32: {firsts})")
        model.policy = get_policy("mirage")
    # resize 4 -> 2 -> 4 slots mid-drain, against a fixed 4-slot engine
    # fed the same arrivals (the first two requests, then the rest); a
    # paged engine's pool follows the slots
    resize_kw = paged if napp else {}
    resized = {}
    for name in ("fixed", "resized"):
        server = LMServer(model, cap=CAP, batch_slots=SLOTS, **resize_kw)
        reqs = make_requests(Request, vocab)
        for r in reqs[:2]:
            server.submit(r)
        done = server.tick() + server.tick()
        if name == "resized":
            server.resize_slots(2)
            if server.alloc is not None:
                # the blocks in use and those reserved for the live
                # requests' growth, no more
                server.resize_block_pool(server.alloc.n_blocks -
                                         server._free_budget())
        done += server.tick() + server.tick()
        if name == "resized":
            server.resize_slots(SLOTS)
            if server.alloc is not None:
                server.resize_block_pool(SLOTS * -(-CAP // PAGED_BS))
        for r in reqs[2:]:
            server.submit(r)
        done += server.run_until_drained()
        resized[name] = {r.rid: r.tokens_out for r in done}
        check_drain(f"{phase} {name}", done, N_REQUESTS, MAX_TOKENS, vocab)
        del server
    rows["resize"] = {"slots": [SLOTS, 2, SLOTS],
                      "layout": resize_kw.get("cache_layout", "dense"),
                      "streams_equal_fixed":
                          resized["resized"] == resized["fixed"],
                      "fixed_streams_equal_dense":
                          resized["fixed"] == ref_streams}
    if resized["resized"] != resized["fixed"]:
        differing.append("resize")
    # switch_backend mirage -> mirage_rns (programmed) -> mirage
    server = LMServer(model, cap=CAP, batch_slots=SLOTS)
    reqs = make_requests(Request, vocab)
    for r in reqs:
        server.submit(r)
    done = []
    for _ in range(SWITCH_AFTER_TICKS):
        done += server.tick()
    server.switch_backend(get_policy("mirage_rns"))
    programmed = server.stationary_weights
    for _ in range(SWITCH_AFTER_TICKS):
        done += server.tick()
    server.switch_backend(get_policy("mirage"))
    done += server.run_until_drained()
    switched = {r.rid: r.tokens_out for r in done}
    rows["switch"] = {"path": "mirage -> mirage_rns -> mirage",
                      "after_ticks": SWITCH_AFTER_TICKS,
                      "mirage_rns_programmed": programmed,
                      "streams_equal_dense": switched == ref_streams}
    check_drain(f"{phase} switch", done, N_REQUESTS, MAX_TOKENS, vocab)
    if not programmed or switched != ref_streams:
        differing.append("switch (or mirage_rns did not program)")
    del server, model
    free_card()
    emit({"phase": phase, "arch": arch, "n_layers": nl,
          "shared_applications": napp, "block_size": PAGED_BS,
          "prefill_chunk": MAMBA_CHUNK, "spec_k": MAMBA_SPEC_K,
          "pipeline_depth": PIPELINE_DEPTH,
          "float_path_engines": list(float_paths), **rows,
          "phase_seconds": time.perf_counter() - t_phase})
    check(not differing, f"{phase}: streams differ from their reference "
                         f"in {differing}")
    return launches_by


def phase_slice_mamba2_rrns(ops):
    """mamba2-2.7b cut to MAMBA_RRNS_LAYERS layers under mirage_rrns at 52
    dB and its clean twin, each engine programming every projection and
    the head once (stationary weights, the SSM family's default), 4
    requests x 8 tokens: the streams equal, no decode beyond the
    correction radius, every kernel-4/5 and kernel-6 launch one residue
    block; the programmed bytes measured. Returns the launches by
    channel."""
    from repro_torch.core import stationary
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    model = published_model(MAMBA_ARCH, MAMBA_RRNS_LAYERS,
                            get_policy("mirage"))
    cfg = model.cfg
    rows, streams, launches_by = {}, {}, {}
    for name, policy in (("rrns_52db", get_policy(
            "mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)),
            ("rrns_clean", get_policy("mirage_rrns",
                                      noise_seed=NOISE_SEED))):
        model.policy = policy
        reqs = make_requests(Request, cfg.vocab_size,
                             max_tokens=MAMBA_RRNS_TOKENS)[
            :MAMBA_RRNS_REQUESTS]
        summary, streams[name], health, launches, blocks, programmed, \
            finished = moe_rns_drain(ops, model, reqs)
        encoded = [m.stationary for m in model.modules()
                   if getattr(m, "stationary", None) is not None]
        residue_gb = sum(e.residues.numel() * e.residues.element_size()
                         for e in encoded) / 1e9
        del encoded
        kernel = "rns_matmul_channel" if name == "rrns_52db" \
            else "rns_matmul"
        want = {kernel: blocks, "rrns_decode": blocks}
        rows[name] = {**summary, "stationary_weights": programmed,
                      "stationary_residues_gb": residue_gb,
                      "health": health, "expected_launches": want}
        check_drain(f"slice_mamba2_rrns {name}", finished,
                    MAMBA_RRNS_REQUESTS, MAMBA_RRNS_TOKENS, cfg.vocab_size)
        expect_launches(launches, want, f"slice_mamba2_rrns {name}")
        per_step = 2 * cfg.n_layers + 1
        check(programmed and blocks >= per_step * summary["model_steps"],
              f"slice_mamba2_rrns {name}: the engine did not program its "
              f"weights, or ran {blocks} residue blocks for "
              f"{summary['model_steps']} model steps")
        launches_by[name] = launches
        stationary.install(model, None)
        free_card()
    health = rows["rrns_52db"]["health"]
    equal = streams["rrns_52db"] == streams["rrns_clean"]
    emit({"phase": "slice_mamba2_rrns", "arch": MAMBA_ARCH,
          "n_layers": cfg.n_layers, "snr_db": SNR_DB,
          "noise_seed": NOISE_SEED, **rows,
          "streams_equal_clean": equal,
          "phase_seconds": time.perf_counter() - t_phase})
    check(health["rrns_uncorrected"] == 0,
          f"slice_mamba2_rrns: {health['rrns_uncorrected']} decodes beyond "
          f"the correction radius at {SNR_DB} dB")
    check(equal, "slice_mamba2_rrns: the 52 dB streams differ from the "
                 "clean channel's")
    del model
    free_card()
    return launches_by


def mamba_layer_grads_vs_cpu(model, batch, li: int = 0):
    """fp32 gradients of layer ``li`` (its projections, ``conv_w``,
    ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and norms) on the card
    against the CPU's, teacher-forced: both sides take the card's token
    embeddings and one seeded upstream gradient of the layer's output."""
    from repro_torch.core.precision import get_policy
    from repro_torch.models import common

    fp32 = get_policy("fp32")
    shell = layer_shell(model, li)
    shell.policy = fp32
    policy0 = model.policy
    model.policy = fp32
    toks = torch.from_numpy(batch["tokens"]).to(DEV)
    with torch.no_grad():
        h = common.embed(model.embed, toks)
    grads = {}
    for side, m, layer, dev in (("card", model, model.layers[li], DEV),
                                ("cpu", shell, shell.layers[0], "cpu")):
        out = m._mamba_block(layer, h.to(dev))
        gen = torch.Generator(device="cpu").manual_seed(11)
        dout = torch.randn(out.shape, generator=gen).to(dev)
        names = [n for n, _ in layer.named_parameters()]
        g = torch.autograd.grad(out, list(layer.parameters()), dout)
        grads[side] = {f"layers.{li}.{n}": x.cpu() for n, x in zip(names, g)}
    model.policy = policy0
    return {n: rel_l2(grads["card"][n], v) for n, v in grads["cpu"].items()}


def phase_slice_train_mamba2(ops):
    """mamba2-2.7b at full width cut to MAMBA_LAYERS layers trained as
    ``python -m repro_torch.launch.train --arch mamba2-2.7b --layers 16``
    trains it: 10 steps of batch 4 x 64, AdamW lr 1e-3, clip 1.0, mirage;
    every forward, dX and dW GEMM one launch of kernel 1 (3 x (2 x layers
    + 1) a step), finite
    losses; step time, tokens/s, the share of model FLOPs (the GEMMs
    only: the SSD scan's are left out), peak memory and the step's split;
    two steps from one state bitwise equal; layer 0's fp32 gradients
    (``A_log``, ``D``, ``dt_bias``, ``conv_w`` among them) teacher-forced
    against the CPU."""
    from repro_torch.core.precision import get_policy

    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("mirage"), MAMBA_ARCH,
                                       MAMBA_LAYERS)
    per_step = 3 * (2 * cfg.n_layers + 1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, step, times, logs = run_train(model, tc, data, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    gemm_w = sum(m.w.numel() for m in model.modules() if hasattr(m, "w"))
    flops = 6.0 * gemm_w * tokens
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    finite = all(math.isfinite(v) for v in losses + norms)
    want = {"mirage_gemm": per_step * TRAIN_STEPS}
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": "slice_train_mamba2", "arch": MAMBA_ARCH,
          "n_layers": cfg.n_layers, "params": n_params,
          "gemm_weights": gemm_w, "train_state_gb": 16.0 * n_params / 1e9,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "optimizer": "adamw lr=1e-3 clip=1.0",
          "gemm_per_step": per_step, "launches": launches,
          "expected_launches": want,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_2_on": step_s * 1e3, "tok_per_s": tokens / step_s,
          "peak_mem_gb": peak, "build_model_s": build_s,
          "model_flops_per_step": flops,
          "model_flops_note": "6 x GEMM weights x tokens; the SSD scan's "
                              "FLOPs are left out",
          "model_flops_share_of_989_tflops": flops / step_s /
          BF16_FLOPS_PER_S, "losses": losses, "grad_norms": norms})
    check(finite, f"slice_train_mamba2: a loss or grad norm is not "
                  f"finite: {losses} {norms}")
    expect_launches(launches, want, "slice_train_mamba2")
    prof = device_profile(lambda: step(state, next(data)), 1, host=False)
    emit({"phase": "slice_train_mamba2_profile", "steps": 1, **{
        k.replace("_ms", "_ms_per_step"): v for k, v in prof.items()},
        "gemm_ms_per_step": gemm_share(prof)})
    emit({"phase": "slice_train_mamba2_breakdown", "steps": 2,
          **step_breakdown(model, tc, state, data, 2)})
    del state
    free_card()
    batch = {k: np.asarray(v) for k, v in next(data).items()}
    losses2, digests = repeat_step(model, batch)
    same = bool(torch.equal(losses2[0].view(torch.int32),
                            losses2[1].view(torch.int32))) and \
        digests[0] == digests[1]
    check(same, f"slice_train_mamba2: two steps from one state differ: "
                f"{[float(v) for v in losses2]} {digests}")
    free_card()
    t0 = time.perf_counter()
    errs = mamba_layer_grads_vs_cpu(model, batch)
    ok = max(errs.values()) < LAYER_GRAD_RTOL
    emit({"phase": "slice_train_mamba2_checks",
          "repeat_losses": [float(v) for v in losses2],
          "repeat_grad_digests": digests, "repeat_bitwise_equal": same,
          "fp32_grads_vs_cpu_rel_l2": errs,
          "fp32_grads_rtol": LAYER_GRAD_RTOL,
          "cpu_seconds": time.perf_counter() - t0, "ok": ok,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok, f"slice_train_mamba2: layer 0's fp32 gradients differ from "
              f"the CPU's by >= {LAYER_GRAD_RTOL} relative L2: {errs}")
    del model
    free_card()
    return launches


# --------------------------------------------------------------------------
# slice 6f: the hybrid family (zamba2-2.7b)
# --------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-2.7b"
#: the served and trained depth (the published 54 layers: 9 applications
#: of the shared block), and the RRNS drains' and fp32 gate's cut (12
#: layers: 2 applications)
ZAMBA_LAYERS, ZAMBA_CUT_LAYERS = 54, 12
#: the engines' cut (6 layers: 1 application; 12 in PR 25, cut in PR 26
#: for the script's time limit)
ZAMBA_ENGINE_LAYERS = 6
ZAMBA_APPS = ZAMBA_LAYERS // 6
#: the shared block's GEMMs an application: proj, q, k, v, o, gate, up, down
ZAMBA_SHARED_GEMMS = 8
#: teacher-forced layer units against the CPU (PR 11's gate)
ZAMBA_LAYER_RTOL = 0.005
ZAMBA_RRNS_REQUESTS, ZAMBA_RRNS_TOKENS = 4, 8
#: kernel 1 at zamba2-2.7b's GEMM shapes: (GEMM, kind, M, K, N, launches a
#: model step of its path). in_proj is 2,560 -> 10,448 (N % 64 = 16: a
#: ragged last column tile), out_proj and the shared proj 5,120 -> 2,560,
#: the shared attention 2,560 -> 2,560 (32 heads of 80, MHA), its MLP
#: 2,560 -> 10,240 -> 2,560, the untied head 2,560 -> 32,000; a prefill of
#: 128 tokens; training 256 tokens (dX on the weight's (N, K) view read in
#: place, dW on X's transposed view)
ZAMBA_GEMMS = (
    ("in_proj (decode)", "fwd", SLOTS, 2560, 10448, ZAMBA_LAYERS),
    ("out_proj, shared proj (decode)", "fwd", SLOTS, 5120, 2560,
     ZAMBA_LAYERS + ZAMBA_APPS),
    ("shared q/k/v/o (decode)", "fwd", SLOTS, 2560, 2560, 4 * ZAMBA_APPS),
    ("shared gate/up (decode)", "fwd", SLOTS, 2560, 10240, 2 * ZAMBA_APPS),
    ("shared down (decode)", "fwd", SLOTS, 10240, 2560, ZAMBA_APPS),
    ("head (decode)", "fwd", SLOTS, 2560, 32000, 1),
    ("in_proj (prefill)", "fwd", 128, 2560, 10448, ZAMBA_LAYERS),
    ("shared gate/up (prefill)", "fwd", 128, 2560, 10240, 2 * ZAMBA_APPS),
    ("in_proj dX (train)", "dX", 256, 2560, 10448, ZAMBA_LAYERS),
    ("in_proj dW (train)", "dW", 256, 2560, 10448, ZAMBA_LAYERS),
    ("shared proj dX (train)", "dX", 256, 5120, 2560, ZAMBA_APPS),
    ("shared proj dW (train)", "dW", 256, 5120, 2560, ZAMBA_APPS),
    ("shared gate/up dX (train)", "dX", 256, 2560, 10240, 2 * ZAMBA_APPS),
    ("shared gate/up dW (train)", "dW", 256, 2560, 10240, 2 * ZAMBA_APPS),
    ("shared down dX (train)", "dX", 256, 10240, 2560, ZAMBA_APPS),
    ("shared down dW (train)", "dW", 256, 10240, 2560, ZAMBA_APPS),
    ("head dX (train)", "dX", 256, 2560, 32000, 1),
    ("head dW (train)", "dW", 256, 2560, 32000, 1),
)
#: flash at the shared block's prefill shapes: (B, L, H, Kv, D), 32 heads
#: of 80 over 32 kv heads (MHA), causal, no window
ZAMBA_FLASH = ((4, 128, 32, 32, 80), (1, 17, 32, 32, 80),
               (2, 64, 32, 32, 80))


def phase_slice_zamba2_kernels(ops, ref, policy, flash_regs):
    """Row 1f (kernel 1 at every GEMM shape of the hybrid's paths: the
    decode tick's Mamba2 projections, the shared block's 8 GEMMs and the
    head; a prefill's in_proj and shared MLP; the training dX and dW of
    in_proj, the shared proj, the shared MLP and the head) and row 3c
    (flash at D = 80, MHA, the shared block's prefill shapes), each held
    against its plain version, twice bitwise, and timed beside its library
    call and bound (``timing`` lines with ``"path": "slice_6f"``). Returns
    (GEMM rows, flash rows, the worst GEMM and flash errors)."""
    t_phase = time.perf_counter()
    gemm_rows, flash_rows = [], []
    worst_gemm = worst_flash = 0.0
    for i, (name, kind, M, K, N, per_step) in enumerate(ZAMBA_GEMMS):
        a, b = mamba_gemm_operands(kind, M, K, N, seed=2600 + i)
        row = {"arch": ZAMBA_ARCH, "gemm": name, "kind": kind,
               "launches_per_step": per_step,
               **gemm_ab_row(ops, ref, policy, a, b)}
        gemm_rows.append(row)
        emit({"phase": "timing", "kernel": "mirage_gemm",
              "path": "slice_6f", **row})
        check(row["bad"] == 0 and row["bitwise_repeatable"],
              f"slice 6f GEMM {name}: outside the bound in {row['bad']} "
              f"elements, or not repeatable")
        worst_gemm = max(worst_gemm, row["max_abs_err"])
        del a, b
        free_card()
    for i, (B, L, H, Kv, D) in enumerate(ZAMBA_FLASH):
        row = flash_case_row(ops, ref, ZAMBA_ARCH, B, L, H, Kv, D, 2700 + i,
                             "slice_6f")
        row["ptxas"] = flash_regs.get(D)
        flash_rows.append(row)
        worst_flash = max(worst_flash, row["max_abs_err"])
    emit({"phase": "slice_zamba2_kernels", "gemms": len(gemm_rows),
          "flash_cases": len(flash_rows), "max_abs_err_gemm": worst_gemm,
          "max_abs_err_flash": worst_flash,
          "flash_d80_ptxas": flash_regs.get(80),
          "phase_seconds": time.perf_counter() - t_phase})
    return gemm_rows, flash_rows, worst_gemm, worst_flash


def hybrid_unit(model, layer, li: int, h, emb0, pos, flash: bool = False):
    """Mamba2 layer ``layer`` (layer ``li`` of the stack) of a hybrid
    model over a full sequence and, where the shared block follows layer
    ``li``, that application of ``model.shared`` (reading ``emb0``); the
    flash kernel in the shared attention where asked, as a serving
    prefill runs it."""
    out = model._mamba_block(layer, h)
    if model._applies_shared(li) is not None:
        out = model._shared_full(out, emb0, pos, flash)[0]
    return out


def hybrid_layers_vs_cpu(model, prompt_np, layers):
    """Teacher-forced units of the hybrid, the card (the shared attention
    through the flash kernel) against the CPU's plain path: each listed
    Mamba2 layer with the shared application after it where there is one,
    both sides fed the card's input and the prompt's embeddings as
    ``emb0``, the layer's and the shared block's weights copied to the
    host on their BFP grid; then the final norm and the head at the last
    position. Returns {unit: relative L2}, the CPU seconds and L."""
    from repro_torch.models import common

    L = len(prompt_np)
    prompt = torch.from_numpy(prompt_np[None].astype(np.int64)).to(DEV)
    t0 = time.perf_counter()
    errs, shared_h = {}, None
    with torch.inference_mode():
        h, _ = model._embed_inputs(prompt)
        emb0 = h
        pos = torch.arange(L, device=DEV)
        for li, layer_d in enumerate(model.layers):
            out_d = hybrid_unit(model, layer_d, li, h, emb0, pos, flash=True)
            if li in layers:
                shell = layer_shell(model, li, gridded=True)
                if shared_h is None:
                    shared_h = gridded_cpu_copy(model.shared, model.policy)
                shell.shared = shared_h
                out_h = hybrid_unit(shell, shell.layers[0], li, h.cpu(),
                                    emb0.cpu(), pos.cpu())
                name = f"layer_{li}" + (
                    "" if model._applies_shared(li) is None else "_shared")
                errs[name] = rel_l2(out_d.cpu(), out_h)
                del shell
            h = out_d
        norm = copy.deepcopy(model.final_norm).to("cpu")
        lm_head = copy.deepcopy(model.lm_head).to("cpu")
        cfg = model.cfg
        last = h[:, -1:]
        plain = common.dense(lm_head, common.norm(
            norm, last.cpu(), cfg.norm_eps, cfg.norm_type), model.policy)
        errs["head"] = rel_l2(model._head(last).cpu(), plain)
    return errs, time.perf_counter() - t0, L


def shared_block_timing(model):
    """One application of the shared block as a decode tick runs it (SLOTS
    rows at position CAP // 2 of dense rings of CAP positions), timed with
    the L2 flushed before each call (the block's 0.47 GB outgrows the L2,
    so each of a tick's applications reads it again), against its byte
    bound: the block's weights and the application's K/V rings read once.
    """
    from repro_torch.models import attention

    cfg = model.cfg
    cache = model.init_cache(SLOTS, CAP, per_slot_idx=True)
    kc, vc = cache["shared_k"][0], cache["shared_v"][0]
    idx = torch.full((SLOTS,), CAP // 2, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(31)
    h = torch.randn((SLOTS, 1, cfg.d_model), generator=gen, device=DEV)
    emb0 = 0.02 * torch.randn((SLOTS, 1, cfg.d_model), generator=gen,
                              device=DEV)

    def attend(attn, x):
        return attention.attn_decode_step(
            attn, x, kc, vc, idx, model.policy, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta)[0]

    def one_application():
        with torch.inference_mode():
            return model._shared_apply(h, emb0, attend)

    weights_gb = sum(p.numel() for p in model.shared.parameters()) * 4 / 1e9
    kv_gb = 2 * kc.numel() * 4 / 1e9
    ms = time_ms(one_application, n=10)
    bound_app = (weights_gb + kv_gb) * 1e9 / HBM_BYTES_PER_S * 1e3
    napp = ssm_napp(cfg)
    del cache, kc, vc
    return {"weights_gb": weights_gb, "kv_gb_an_application": kv_gb,
            "ms_an_application": ms, "bound_ms_an_application": bound_app,
            "applications_a_tick": napp, "ms_a_tick": ms * napp,
            "bound_ms_a_tick": bound_app * napp,
            "reread_gb_a_tick": (napp - 1) * weights_gb,
            "reread_bound_ms_a_tick":
                (napp - 1) * weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3}


def phase_slice_zamba2(ops):
    """zamba2-2.7b at its published widths and full depth (54 Mamba2
    layers, the shared block applied 9 times; random weights from seed 0)
    served under mirage: the slice's requests cold and warmed (the tick a
    CUDA graph), the streams equal, kernel 1 launched 2 x 54 + 8 x 9 + 1
    times a model step and flash 9 times a prefill batch (exact-length
    batches), the steady tick cold against warmed and profiled, against
    its byte bound (the weights, the shared block re-read at each
    application, the state read and written, the shared KV read); one
    shared application timed alone; then layers 0, 5 (with the first
    application) and 53 (with the last) and the head teacher-forced
    against the CPU (``zamba2_vs_cpu_plain``, PR 11's 0.005), and at 12
    layers (2 applications) under fp32 the logits and the decode after a
    prefill against the CPU. Returns the launches by engine."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    model = published_model(ZAMBA_ARCH, ZAMBA_LAYERS, get_policy("mirage"))
    cfg = model.cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    napp, per_step = ssm_napp(cfg), ssm_per_step(cfg)
    rows, _, launches_by = serve_cold_and_warmed(
        ops, model, "slice_zamba2", per_step, napp)
    prof = rows["warmed_tick_profile"]
    gemm_ms = gemm_share(prof)
    weights_gb, _ = decode_bound_ms(model)
    state_gb = ssm_state_gb(model, SLOTS)
    shared = shared_block_timing(model)
    spec = model.cache_spec(SLOTS, CAP, per_slot_idx=True)
    kv_gb = sum(math.prod(shape) * 4 for k, (shape, _) in spec.items()
                if k in ("shared_k", "shared_v")) / 1e9
    # a tick reads every weight once, the shared block's again at each
    # application after the first, every slot's recurrent state (read and
    # written) and every application's K/V rings
    bound_gb = weights_gb + shared["reread_gb_a_tick"] + 2 * state_gb + kv_gb
    emit({"phase": "slice_zamba2", "arch": ZAMBA_ARCH, "params": n_params,
          "shared_params": sum(p.numel() for p in model.shared.parameters()),
          "f32_gb": n_params * 4 / 1e9, "n_layers": cfg.n_layers,
          "shared_applications": napp, "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads,
          "ssm_state": cfg.ssm_state, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "vocab": cfg.vocab_size,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)", "slots": SLOTS,
          "cap": CAP, "gemm_per_step": per_step,
          "flash_per_prefill_batch": napp,
          "prefill": "batches of one exact prompt length", **rows,
          "state_gb_4_slots": state_gb, "shared_kv_gb_4_slots": kv_gb,
          "decode_bound_gb": bound_gb,
          "decode_bound_ms": bound_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
          "shared_block": shared,
          "warmed_tick_gemm_ms": gemm_ms,
          "warmed_tick_gemm_share_of_busy":
              gemm_ms / prof["device_busy_ms"],
          "warmed_tick_ssm_attention_and_glue_ms":
              prof["device_busy_ms"] - gemm_ms})
    prompt = make_requests(Request, cfg.vocab_size)[0].prompt[:16]
    every = cfg.attn_every
    errs, cpu_s, L = hybrid_layers_vs_cpu(
        model, prompt, (0, every - 1, cfg.n_layers - 1))
    del model
    free_card()
    fp32 = mamba_fp32_vs_cpu(prompt, ZAMBA_ARCH, ZAMBA_CUT_LAYERS)
    ok_layers = max(errs.values()) < ZAMBA_LAYER_RTOL
    ok_fp32 = max(v for k, v in fp32.items() if k.startswith(
        ("forward", "decode"))) < MAMBA_FP32_RTOL
    emit({"phase": "zamba2_vs_cpu_plain", "prompt_len": L,
          "rel_l2": errs, "cpu_seconds": cpu_s,
          "layers_rtol": ZAMBA_LAYER_RTOL, "fp32": fp32,
          "fp32_rtol": MAMBA_FP32_RTOL, "ok": ok_layers and ok_fp32,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok_layers, f"zamba2 card vs CPU: a teacher-forced unit or the "
                     f"head differs by >= {ZAMBA_LAYER_RTOL} relative L2: "
                     f"{errs}")
    check(ok_fp32, f"zamba2 under fp32: the card's logits or its decode "
                   f"after prefill differ by >= {MAMBA_FP32_RTOL} relative "
                   f"L2: {fp32}")
    return launches_by


class RecordTap:
    """Counts, while open, the health records of one name (each RRNS
    decode records ``rrns_uncorrected`` once)."""

    def __init__(self, name: str = "rrns_uncorrected"):
        from repro_torch.obs import health
        self.cls, self.name, self.records = health.HealthCollector, name, 0

    def __enter__(self):
        self.inner = inner = self.cls.add
        tap = self

        def add(collector, name, value):
            if name == tap.name:
                tap.records += 1
            inner(collector, name, value)

        self.cls.add = add
        return self

    def __exit__(self, *exc):
        self.cls.add = self.inner


def phase_slice_zamba2_rrns(ops):
    """zamba2-2.7b cut to 12 layers under mirage_rrns at 52 dB and its
    clean twin, each engine programming every projection, the shared
    block's 8 weights and the head once (stationary weights, the family's
    default), 4 requests x 8 tokens: the streams equal, no decode beyond
    the correction radius, every kernel-4/5 and kernel-6 launch one
    residue block; the health integers count the Mamba2 projections' and
    the head's decodes alone (2 x 12 + 1 GEMM calls a model step under
    the open scope, the shared block's 8 x 2 suppressed, one record a
    counted block), as the JAX package's ``_cond_suppressed`` leaves the
    shared block out. Returns the launches by channel."""
    from repro_torch.core import stationary
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    model = published_model(ZAMBA_ARCH, ZAMBA_CUT_LAYERS,
                            get_policy("mirage"))
    cfg = model.cfg
    napp = ssm_napp(cfg)
    rows, streams, launches_by = {}, {}, {}
    for name, policy in (("rrns_52db", get_policy(
            "mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)),
            ("rrns_clean", get_policy("mirage_rrns",
                                      noise_seed=NOISE_SEED))):
        model.policy = policy
        reqs = make_requests(Request, cfg.vocab_size,
                             max_tokens=ZAMBA_RRNS_TOKENS)[
            :ZAMBA_RRNS_REQUESTS]
        with RecordTap() as rec:
            summary, streams[name], health, launches, blocks, programmed, \
                finished = moe_rns_drain(ops, model, reqs)
        encoded = [m.stationary for m in model.modules()
                   if getattr(m, "stationary", None) is not None]
        residue_gb = sum(e.residues.numel() * e.residues.element_size()
                         for e in encoded) / 1e9
        del encoded
        kernel = "rns_matmul_channel" if name == "rrns_52db" \
            else "rns_matmul"
        want = {kernel: blocks, "rrns_decode": blocks,
                "flash_attention": napp * summary["prefill_batches"]}
        steps = summary["model_steps"]
        counted = (2 * cfg.n_layers + 1) * steps
        suppressed = ZAMBA_SHARED_GEMMS * napp * steps
        rows[name] = {**summary, "stationary_weights": programmed,
                      "stationary_residues_gb": residue_gb,
                      "health": health, "health_records": rec.records,
                      "expected_gemm_calls_counted": counted,
                      "expected_gemm_calls_suppressed": suppressed,
                      "expected_launches": want}
        check_drain(f"slice_zamba2_rrns {name}", finished,
                    ZAMBA_RRNS_REQUESTS, ZAMBA_RRNS_TOKENS, cfg.vocab_size)
        expect_launches(launches, want, f"slice_zamba2_rrns {name}")
        check(programmed and model.shared.proj.stationary is not None,
              f"slice_zamba2_rrns {name}: the engine did not program its "
              f"weights, the shared block's among them")
        check(summary["gemm_calls_health_counted"] == counted and
              summary["gemm_calls_health_suppressed"] == suppressed and
              rec.records == summary["residue_blocks_health_counted"],
              f"slice_zamba2_rrns {name}: the health integers do not count "
              f"exactly the Mamba2 and head GEMMs' decodes: "
              f"{summary['gemm_calls_health_counted']} / {counted} counted "
              f"calls, {summary['gemm_calls_health_suppressed']} / "
              f"{suppressed} suppressed, {rec.records} records for "
              f"{summary['residue_blocks_health_counted']} blocks")
        launches_by[name] = launches
        stationary.install(model, None)
        free_card()
    health = rows["rrns_52db"]["health"]
    equal = streams["rrns_52db"] == streams["rrns_clean"]
    emit({"phase": "slice_zamba2_rrns", "arch": ZAMBA_ARCH,
          "n_layers": cfg.n_layers, "shared_applications": napp,
          "snr_db": SNR_DB, "noise_seed": NOISE_SEED, **rows,
          "streams_equal_clean": equal,
          "phase_seconds": time.perf_counter() - t_phase})
    check(health["rrns_uncorrected"] == 0,
          f"slice_zamba2_rrns: {health['rrns_uncorrected']} decodes beyond "
          f"the correction radius at {SNR_DB} dB")
    check(equal, "slice_zamba2_rrns: the 52 dB streams differ from the "
                 "clean channel's")
    del model
    free_card()
    return launches_by


def hybrid_unit_grads_vs_cpu(model, batch, li: int):
    """fp32 gradients of layer ``li`` and of the shared block's
    application after it on the card against the CPU's, teacher-forced:
    both sides take the card's fp32 input to layer ``li`` (the layers
    before it run on the card), the batch's embeddings as ``emb0`` and one
    seeded upstream gradient of the unit's output."""
    from repro_torch.core.precision import get_policy
    from repro_torch.models import common

    fp32 = get_policy("fp32")
    shell = layer_shell(model, li)
    shell.shared = copy.deepcopy(model.shared).to("cpu")
    shell.policy = fp32
    policy0 = model.policy
    model.policy = fp32
    toks = torch.from_numpy(batch["tokens"]).to(DEV)
    pos = torch.arange(toks.shape[1], device=DEV)
    with torch.no_grad():
        emb0 = common.embed(model.embed, toks)
        h = emb0
        for i in range(li):
            h = hybrid_unit(model, model.layers[i], i, h, emb0, pos)
    grads = {}
    for side, m, layer, dev in (("card", model, model.layers[li], DEV),
                                ("cpu", shell, shell.layers[0], "cpu")):
        out = hybrid_unit(m, layer, li, h.to(dev), emb0.to(dev), pos.to(dev))
        gen = torch.Generator(device="cpu").manual_seed(11)
        dout = torch.randn(out.shape, generator=gen).to(dev)
        named = [(f"layers.{li}.{n}", p)
                 for n, p in layer.named_parameters()] + \
            [(f"shared.{n}", p) for n, p in m.shared.named_parameters()]
        g = torch.autograd.grad(out, [p for _, p in named], dout)
        grads[side] = {n: x.cpu() for (n, _), x in zip(named, g)}
        del out, g
    model.policy = policy0
    del shell
    return {n: rel_l2(grads["card"][n], v) for n, v in grads["cpu"].items()}


def phase_slice_train_zamba2(ops):
    """zamba2-2.7b at full width and depth trained as ``python -m
    repro_torch.launch.train --arch zamba2-2.7b`` trains it: 10 steps of
    batch 4 x 64, AdamW lr 1e-3, clip 1.0, mirage; every forward, dX and
    dW GEMM one launch of kernel 1 (3 x (2 x 54 + 8 x 9 + 1) a step; the
    shared block's attention plain, as the JAX package trains it), finite
    losses; step time, tokens/s, the share of model FLOPs (the GEMMs, the
    shared block's counted at each of its 9 applications), peak memory
    and the step's split; two steps from one state bitwise equal; layer
    5's and the shared block's fp32 gradients teacher-forced against the
    CPU."""
    from repro_torch.core.precision import get_policy

    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("mirage"), ZAMBA_ARCH)
    napp = ssm_napp(cfg)
    per_step = 3 * ssm_per_step(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, step, times, logs = run_train(model, tc, data, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    shared_w = sum(m.w.numel() for m in model.shared.modules()
                   if hasattr(m, "w"))
    gemm_w = sum(m.w.numel() for m in model.modules() if hasattr(m, "w")) \
        + (napp - 1) * shared_w
    flops = 6.0 * gemm_w * tokens
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    finite = all(math.isfinite(v) for v in losses + norms)
    want = {"mirage_gemm": per_step * TRAIN_STEPS}
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": "slice_train_zamba2", "arch": ZAMBA_ARCH,
          "n_layers": cfg.n_layers, "shared_applications": napp,
          "params": n_params, "gemm_weights_applied": gemm_w,
          "train_state_gb": 16.0 * n_params / 1e9,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "optimizer": "adamw lr=1e-3 clip=1.0",
          "gemm_per_step": per_step, "launches": launches,
          "expected_launches": want,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_2_on": step_s * 1e3, "tok_per_s": tokens / step_s,
          "peak_mem_gb": peak, "build_model_s": build_s,
          "model_flops_per_step": flops,
          "model_flops_note": "6 x GEMM weights (the shared block's once "
                              "an application) x tokens; the SSD scan's "
                              "and attention's FLOPs are left out",
          "model_flops_share_of_989_tflops": flops / step_s /
          BF16_FLOPS_PER_S, "losses": losses, "grad_norms": norms})
    check(finite, f"slice_train_zamba2: a loss or grad norm is not "
                  f"finite: {losses} {norms}")
    expect_launches(launches, want, "slice_train_zamba2")
    prof = device_profile(lambda: step(state, next(data)), 1, host=False)
    emit({"phase": "slice_train_zamba2_profile", "steps": 1, **{
        k.replace("_ms", "_ms_per_step"): v for k, v in prof.items()},
        "gemm_ms_per_step": gemm_share(prof)})
    emit({"phase": "slice_train_zamba2_breakdown", "steps": 2,
          **step_breakdown(model, tc, state, data, 2)})
    del state
    free_card()
    batch = {k: np.asarray(v) for k, v in next(data).items()}
    losses2, digests = repeat_step(model, batch)
    same = bool(torch.equal(losses2[0].view(torch.int32),
                            losses2[1].view(torch.int32))) and \
        digests[0] == digests[1]
    check(same, f"slice_train_zamba2: two steps from one state differ: "
                f"{[float(v) for v in losses2]} {digests}")
    free_card()
    t0 = time.perf_counter()
    li = cfg.attn_every - 1
    errs = hybrid_unit_grads_vs_cpu(model, batch, li)
    ok = max(errs.values()) < LAYER_GRAD_RTOL
    emit({"phase": "slice_train_zamba2_checks",
          "repeat_losses": [float(v) for v in losses2],
          "repeat_grad_digests": digests, "repeat_bitwise_equal": same,
          "fp32_grads_layer": li,
          "fp32_grads_vs_cpu_rel_l2": errs,
          "fp32_grads_rtol": LAYER_GRAD_RTOL,
          "cpu_seconds": time.perf_counter() - t0, "ok": ok,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok, f"slice_train_zamba2: layer {li}'s or the shared block's fp32 "
              f"gradients differ from the CPU's by >= {LAYER_GRAD_RTOL} "
              f"relative L2: {errs}")
    del model
    free_card()
    return launches


# --------------------------------------------------------------------------
# slice 6g: the enc-dec family (seamless-m4t-large-v2)
# --------------------------------------------------------------------------

SEAMLESS_ARCH = "seamless-m4t-large-v2"
#: full depth: 24 encoder and 24 decoder layers
SEAMLESS_LAYERS = 24
#: the served batch: 4 rows of 1,024 frames (the config's frontend_len) and
#: 4 prompts of one length (the model's scalar idx), 32 greedy tokens
SEAMLESS_ROWS, SEAMLESS_FRAMES = 4, 1024
SEAMLESS_PROMPT, SEAMLESS_TOKENS = 16, 32
SEAMLESS_CAP = SEAMLESS_PROMPT + SEAMLESS_TOKENS
#: the fp32 end-to-end gate's cut (6 encoder + 6 decoder layers, one row of
#: 256 frames) and its tokens decoded after a prefill
SEAMLESS_FP32_LAYERS, SEAMLESS_FP32_FRAMES = 6, 256
SEAMLESS_FP32_RTOL = 1e-5
#: the teacher-forced layers (encoder and decoder) and their gates
SEAMLESS_UNITS = (0, 23)
SEAMLESS_LAYER_RTOL = {"mirage": 0.005, "fp32": 1e-5}
#: the RRNS drains' cut (4 + 4 layers; int32 residues of 5 moduli), their
#: frames and tokens
SEAMLESS_RRNS_LAYERS, SEAMLESS_RRNS_FRAMES, SEAMLESS_RRNS_TOKENS = 4, 128, 8
SEAMLESS_TRAIN_STEPS = 5
#: the fp32 gradient gate of slice_train_seamless: a leaf's gradient on the
#: card within LAYER_GRAD_RTOL of the f64 reference's (relative L2), or
#: within this many times the CPU's own f32 distance from it where that is
#: larger (the leaves behind nearly uniform attention scores, whose
#: gradients are differences of nearly equal terms)
SEAMLESS_GRAD_F64_MARGIN = 2.0
#: the cross-attention's key bias: a zero gradient in exact arithmetic (a
#: bias on every key shifts each query's scores by one constant that the
#: softmax drops), held to this share of its unit's largest gradient
SEAMLESS_ZERO_GRAD, SEAMLESS_ZERO_GRAD_ATOL = "cross_attn.k.b", 1e-6
#: kernel 1 at seamless's GEMM shapes: (GEMM, kind, M, K, N, launches a
#: model step of its path: a decode step, a prefill or a training step's
#: dX / dW). A decode step runs the self-attention's q/k/v/o and the
#: cross-attention's q/o at 1,024 -> 1,024, the GELU MLP at 1,024 -> 8,192
#: -> 1,024 and the untied head at N = 256,206 (N % 4 = 2: rows not 16-byte
#: aligned); a prefill of 4 x 1,024 frames runs the encoder's GEMMs and the
#: cross k/v at M = 4,096
SEAMLESS_GEMMS = (
    ("attention 1,024 -> 1,024 (decode)", "fwd", SLOTS, 1024, 1024, 6 * 24),
    ("mlp up (decode)", "fwd", SLOTS, 1024, 8192, 24),
    ("mlp down (decode)", "fwd", SLOTS, 8192, 1024, 24),
    ("head (decode)", "fwd", SLOTS, 1024, 256206, 1),
    ("encoder q/k/v/o and cross k/v (prefill)", "fwd", 4096, 1024, 1024,
     6 * 24),
    ("encoder mlp up (prefill)", "fwd", 4096, 1024, 8192, 24),
    ("encoder mlp down (prefill)", "fwd", 4096, 8192, 1024, 24),
    ("head dX (train)", "dX", 256, 1024, 256206, 1),
    ("head dW (train)", "dW", 256, 1024, 256206, 1),
)
#: flash at the encoder's bidirectional self-attention (row 3d): the
#: served prefill's shape, one row, and the fp32 gate's
SEAMLESS_FLASH = ((4, 1024, 16, 16, 64), (1, 1024, 16, 16, 64),
                  (1, 256, 16, 16, 64))


def seamless_per_step(cfg) -> dict:
    """Kernel-1 launches of the enc-dec paths: a prefill (frontend_proj,
    6 a encoder layer, 10 a decoder layer, the head), a decode step (8 a
    decoder layer: the cross-attention projects q and o alone, and the
    head) and a training step (the prefill's forward, every dW, every dX
    but frontend_proj's: the frames need none); and flash a prefill (every
    encoder layer and every decoder layer's self-attention; the
    cross-attention stays plain, as in the JAX package)."""
    fwd = 1 + 6 * cfg.encoder_layers + 10 * cfg.n_layers + 1
    return {"prefill": fwd, "decode": 8 * cfg.n_layers + 1,
            "train": 3 * fwd - 1,
            "flash_prefill": cfg.encoder_layers + cfg.n_layers}


def seamless_inputs(cfg, rows: int, frames: int, prompt: int):
    """``rows`` rows of ``frames`` f32 normal frames and ``rows`` prompts of
    ``prompt`` tokens, from numpy seed 0."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(rows, frames, cfg.frontend_dim)).astype(np.float32)
    p = rng.integers(0, cfg.vocab_size, (rows, prompt)).astype(np.int64)
    return f, p


def seamless_greedy(model, frames, prompts, n_tokens: int, cap: int,
                    scope=contextlib.nullcontext):
    """The served path: ``prefill`` then greedy ``decode_step``s until
    ``n_tokens`` tokens a row (n_tokens - 1 decode steps: the prefill's
    logits give the first), each model call inside ``scope()``. Returns
    (tokens (B, n_tokens), the prefill's wall ms, each decode step's wall
    ms, the last logits, the cache)."""
    steps_ms = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scope():
            logits, cache = model.prefill(frames, prompts, cap)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks = []
        for i in range(n_tokens):
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            toks.append(nxt)
            if i == n_tokens - 1:
                break
            t0 = time.perf_counter()
            with scope():
                logits, cache = model.decode_step(cache, nxt)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.cat(toks, 1), prefill_ms, steps_ms, logits, cache


def seamless_decode_bound(model, cache) -> tuple:
    """A decode step's bytes (GB) and byte bound (ms): the decoder's
    weights but the cross-attention's k and v (their keys and values are
    cached), the final norm and the untied head, read once; the cross KV
    and the self KV rings read whole."""
    skip = ("cross_attn.k.", "cross_attn.v.")
    n = sum(p.numel() for name, p in model.dec_layers.named_parameters()
            if not any(s in name for s in skip))
    n += sum(p.numel() for p in model.final_norm.parameters())
    n += sum(p.numel() for p in model.lm_head.parameters())
    kv = sum(cache[k].numel() for k in ("self_k", "self_v", "cross_k",
                                         "cross_v"))
    gb = (n + kv) * 4.0 / 1e9
    return gb, gb * 1e9 / HBM_BYTES_PER_S * 1e3, n * 4.0 / 1e9, kv * 4.0 / 1e9


def phase_slice_seamless_kernels(ops, ref, policy):
    """Row 1g (kernel 1 at seamless's GEMM shapes: the decode step's
    attention projections, GELU MLP and untied head at N = 256,206; the
    encoder's prefill GEMMs at M = 4,096; the head's training dX and dW)
    and row 3d (flash non-causal, the encoder's bidirectional attention
    at L = 1,024, 16 heads over 16 of 64), each held against its plain
    version, twice bitwise, and timed beside its library call and bound
    (``timing`` lines with ``"path": "slice_6g"``). Returns (GEMM rows,
    flash rows, the worst GEMM and flash errors)."""
    t_phase = time.perf_counter()
    gemm_rows, flash_rows = [], []
    worst_gemm = worst_flash = 0.0
    for i, (name, kind, M, K, N, per_step) in enumerate(SEAMLESS_GEMMS):
        a, b = mamba_gemm_operands(kind, M, K, N, seed=2800 + i)
        row = {"arch": SEAMLESS_ARCH, "gemm": name, "kind": kind,
               "launches_per_step": per_step,
               **gemm_ab_row(ops, ref, policy, a, b)}
        gemm_rows.append(row)
        emit({"phase": "timing", "kernel": "mirage_gemm",
              "path": "slice_6g", **row})
        check(row["bad"] == 0 and row["bitwise_repeatable"],
              f"slice 6g GEMM {name}: outside the bound in {row['bad']} "
              f"elements, or not repeatable")
        worst_gemm = max(worst_gemm, row["max_abs_err"])
        del a, b
        free_card()
    for i, (B, L, H, Kv, D) in enumerate(SEAMLESS_FLASH):
        row = flash_case_row(ops, ref, SEAMLESS_ARCH, B, L, H, Kv, D,
                             2900 + i, "slice_6g", causal=False)
        flash_rows.append(row)
        worst_flash = max(worst_flash, row["max_abs_err"])
    emit({"phase": "slice_seamless_kernels", "gemms": len(gemm_rows),
          "flash_cases": len(flash_rows), "max_abs_err_gemm": worst_gemm,
          "max_abs_err_flash": worst_flash,
          "phase_seconds": time.perf_counter() - t_phase})
    return gemm_rows, flash_rows, worst_gemm, worst_flash


def encdec_shell(model, enc=(), dec=(), gridded: bool = False,
                 policy=None):
    """A CPU enc-dec model of ``model``'s widths (a vocabulary of 8) holding
    copies of ``model``'s frontend_proj and of the listed encoder and
    decoder layers (the GEMM weights already on their BFP grid where
    ``gridded``: :func:`gridded_cpu_copy`), under ``policy`` (``model``'s
    by default)."""
    from repro_torch.models import build_model

    policy = policy or model.policy
    cfg = dataclasses.replace(model.cfg, n_layers=max(len(dec), 1),
                              encoder_layers=max(len(enc), 1), vocab_size=8)
    shell = build_model(cfg, policy, model.opt, device="cpu")

    def take(module):
        return gridded_cpu_copy(module, policy) if gridded \
            else copy.deepcopy(module).to("cpu")

    shell.frontend_proj = take(model.frontend_proj)
    for i, li in enumerate(enc):
        shell.enc_layers[i] = take(model.enc_layers[li])
    for i, li in enumerate(dec):
        shell.dec_layers[i] = take(model.dec_layers[li])
    if gridded:
        shell.policy = policy.replace(assume_quantized_weights=True)
    return shell


def seamless_layers_vs_cpu(model, frames_np, prompt_np, units):
    """Teacher-forced layers of the enc-dec model, the card (its encoder's
    attention through the flash kernel) against the CPU's plain path, one
    row: the encoder layers and the decoder layers listed in ``units``
    (each fed the card's input on both sides, the decoder layers the
    card's encoder output too), then the final norm and the head at the
    last position. Under ``mirage`` the CPU copies' GEMM weights lie on
    their BFP grid (:func:`gridded_cpu_copy`). Returns ({unit: relative
    L2}, the CPU seconds)."""
    from repro_torch.models import common

    gridded = model.policy.mode != "fp32"
    frames = torch.from_numpy(frames_np[None]).to(DEV)
    prompt = torch.from_numpy(prompt_np[None]).to(DEV)
    t0 = time.perf_counter()
    errs = {}
    shell = encdec_shell(model, units, units, gridded)
    with torch.inference_mode():
        h = common.dense(model.frontend_proj, frames, model.policy)
        pos = torch.arange(h.shape[1], device=DEV)
        for li, layer in enumerate(model.enc_layers):
            out = model.enc_layer(layer, h, pos)
            if li in units:
                i = units.index(li)
                errs[f"enc_layer_{li}"] = rel_l2(out.cpu(), shell.enc_layer(
                    shell.enc_layers[i], h.cpu(), pos.cpu()))
            h = out
        enc_out = model._norm(model.enc_norm, h)
        h = common.embed(model.embed, prompt)
        pos = torch.arange(h.shape[1], device=DEV)
        for li, layer in enumerate(model.dec_layers):
            out = model.dec_layer(layer, h, pos, enc_out)[0]
            if li in units:
                i = units.index(li)
                errs[f"dec_layer_{li}"] = rel_l2(out.cpu(), shell.dec_layer(
                    shell.dec_layers[i], h.cpu(), pos.cpu(),
                    enc_out.cpu())[0])
            h = out
        norm = copy.deepcopy(model.final_norm).to("cpu")
        lm_head = copy.deepcopy(model.lm_head).to("cpu")
        cfg = model.cfg
        last = model._norm(model.final_norm, h[:, -1:])
        plain = common.dense(lm_head, common.norm(
            norm, h[:, -1:].cpu(), cfg.norm_eps, cfg.norm_type),
            model.policy)
        errs["head"] = rel_l2(common.dense(model.lm_head, last,
                                           model.policy).cpu(), plain)
    del shell
    return errs, time.perf_counter() - t0


def seamless_fp32_vs_cpu(frames_np, prompt_np):
    """The enc-dec model at its widths cut to SEAMLESS_FP32_LAYERS of each
    stack, under fp32, one row of SEAMLESS_FP32_FRAMES frames: the card's
    teacher-forced logits (``forward``) and a prefill of all but the last
    MAMBA_DECODE_CHECK tokens then those tokens decoded one at a time,
    against the same on the CPU's plain path, end to end. Returns relative
    L2s."""
    from repro_torch.core.precision import get_policy

    model = published_model(SEAMLESS_ARCH, SEAMLESS_FP32_LAYERS,
                            get_policy("fp32"))
    cpu = copy.deepcopy(model).to("cpu")
    L, n = len(prompt_np), MAMBA_DECODE_CHECK
    out = {}
    with torch.inference_mode():
        for side, m, dev in (("card", model, DEV), ("cpu", cpu, "cpu")):
            f = torch.from_numpy(frames_np[None]).to(dev)
            toks = torch.from_numpy(prompt_np[None]).to(dev)
            full = m.forward(f, toks)
            _, cache = m.prefill(f, toks[:, :L - n], SEAMLESS_CAP)
            for t in range(L - n, L):
                logits, cache = m.decode_step(cache, toks[:, t:t + 1])
            out[side] = (full.cpu(), logits[:, -1].cpu())
    (full_d, dec_d), (full_h, dec_h) = out["card"], out["cpu"]
    n_layers = model.cfg.n_layers
    del model, cpu
    free_card()
    return {"layers": n_layers, "frames": len(frames_np), "prompt_len": L,
            "forward_card_vs_cpu": rel_l2(full_d, full_h),
            "decode_vs_forward_card": rel_l2(dec_d, full_d[:, -1]),
            "decode_vs_forward_cpu": rel_l2(dec_h, full_h[:, -1]),
            "decode_card_vs_forward_cpu": rel_l2(dec_d, full_h[:, -1])}


def phase_slice_seamless(ops):
    """seamless-m4t-large-v2 at its published widths and full depth (24
    encoder and 24 decoder layers; random weights from seed 0) served as
    the JAX package serves it, the model's own prefill and greedy decode
    (no engine serves enc-dec in either package): 4 rows of 1,024 frames
    and 4 prompts of 16 tokens, 32 tokens a row, under mirage; kernel 1
    launched 386 times a prefill and 193 a decode step, flash 48 times a
    prefill (every encoder layer non-causal, every decoder self-attention
    causal); the decode step's wall time, busy time and idle share against
    its byte bound; peak memory; the tokens in the vocabulary and the
    logits finite. Then ``seamless_vs_cpu_plain``: encoder layers 0 and 23,
    decoder layers 0 and 23 and the head teacher-forced against the CPU
    under mirage (0.005 relative L2) and fp32 (1e-5), and at 6 + 6 layers
    under fp32 the logits and the decode after a prefill end to end
    (1e-5). Returns the launches."""
    from repro_torch.core.precision import get_policy

    t_phase = time.perf_counter()
    model = published_model(SEAMLESS_ARCH, SEAMLESS_LAYERS,
                            get_policy("mirage"))
    cfg = model.cfg
    per = seamless_per_step(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    frames_np, prompts_np = seamless_inputs(
        cfg, SEAMLESS_ROWS, cfg.frontend_len if not REDUCED else 16,
        SEAMLESS_PROMPT)
    frames = torch.from_numpy(frames_np).to(DEV)
    prompts = torch.from_numpy(prompts_np).to(DEV)
    # a short run first: the launches and times below are the cold
    # path's, not the first call's
    seamless_greedy(model, frames[:, :64].contiguous(), prompts, 2,
                    SEAMLESS_CAP)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, prefill_ms, steps_ms, logits, cache = seamless_greedy(
        model, frames, prompts, SEAMLESS_TOKENS, SEAMLESS_CAP)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_steps = SEAMLESS_TOKENS - 1
    want = {"mirage_gemm": per["prefill"] + per["decode"] * n_steps,
            "flash_attention": per["flash_prefill"]}
    expect_launches(launches, want, "slice_seamless")
    finite = bool(torch.isfinite(logits).all())
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    nxt = toks[:, -1:].contiguous()

    def one_step():
        with torch.inference_mode():
            model.decode_step(cache, nxt)

    prof = device_profile(one_step, 3)
    bound_gb, bound_ms, weights_gb, kv_gb = seamless_decode_bound(
        model, cache)
    rows = {"prefill_ms": prefill_ms, "decode_step_ms": steps_ms,
            "decode_step_ms_median": statistics.median(steps_ms),
            "decode_step_profile": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "device_kernels", "top_device_ms", "port_kernels_ms")},
            "decode_step_gemm_ms": gemm_share(prof),
            "tok_per_s": SEAMLESS_ROWS * SEAMLESS_TOKENS /
            ((prefill_ms + sum(steps_ms)) / 1e3)}
    del cache, logits
    emit({"phase": "slice_seamless", "arch": SEAMLESS_ARCH,
          "params": n_params, "f32_gb": n_params * 4 / 1e9,
          "encoder_layers": cfg.encoder_layers, "decoder_layers":
          cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "rows": SEAMLESS_ROWS, "frames": frames_np.shape[1],
          "prompt_len": SEAMLESS_PROMPT, "tokens": SEAMLESS_TOKENS,
          "cap": SEAMLESS_CAP, "decode_steps": n_steps,
          "launches": launches, "expected_launches": want,
          "gemm_per_prefill": per["prefill"],
          "gemm_per_decode_step": per["decode"],
          "flash_per_prefill": per["flash_prefill"], **rows,
          "decode_bound_gb": bound_gb, "decode_bound_ms": bound_ms,
          "decode_bound_weights_gb": weights_gb,
          "decode_bound_kv_gb": kv_gb, "peak_mem_gb": peak,
          "tokens_row_0": toks[0].tolist(), "logits_finite": finite,
          "tokens_in_vocab": in_vocab})
    check(finite and in_vocab, "slice_seamless: non-finite logits or a "
                               "token outside the vocabulary")
    errs = {}
    cpu_s = 0.0
    for name in ("mirage", "fp32"):
        model.policy = get_policy(name)
        errs[name], dt = seamless_layers_vs_cpu(
            model, frames_np[0], prompts_np[0], SEAMLESS_UNITS)
        cpu_s += dt
    del model, frames, prompts
    free_card()
    fp32 = seamless_fp32_vs_cpu(frames_np[0, :SEAMLESS_FP32_FRAMES],
                                prompts_np[0])
    ok_layers = all(max(errs[k].values()) <= SEAMLESS_LAYER_RTOL[k]
                    for k in errs)
    ok_fp32 = max(v for k, v in fp32.items() if k.startswith(
        ("forward", "decode"))) <= SEAMLESS_FP32_RTOL
    emit({"phase": "seamless_vs_cpu_plain", "prompt_len": SEAMLESS_PROMPT,
          "frames": frames_np.shape[1], "rel_l2": errs,
          "cpu_seconds": cpu_s, "layers_rtol": SEAMLESS_LAYER_RTOL,
          "fp32": fp32, "fp32_rtol": SEAMLESS_FP32_RTOL,
          "ok": ok_layers and ok_fp32,
          "phase_seconds": time.perf_counter() - t_phase})
    check(ok_layers, f"seamless card vs CPU: a teacher-forced layer or the "
                     f"head differs beyond {SEAMLESS_LAYER_RTOL} relative "
                     f"L2: {errs}")
    check(ok_fp32, f"seamless under fp32: the card's logits or its decode "
                   f"after prefill differ by > {SEAMLESS_FP32_RTOL} "
                   f"relative L2: {fp32}")
    return launches


def phase_slice_seamless_rrns(ops):
    """seamless-m4t-large-v2 cut to 4 encoder and 4 decoder layers under
    mirage_rrns at 52 dB and its clean twin, every GEMM weight programmed
    once (stationary residues, as the engine programs a dense model), 4
    rows of 128 frames, 16-token prompts and 8 tokens: the streams equal,
    no decode beyond the correction radius, every kernel-4/5 and kernel-6
    launch one residue block, flash once an encoder layer and a decoder
    self-attention, and every GEMM call of the path counted in the health
    scope (66 a prefill, 33 a decode step at this cut) with one record a
    block. Returns the launches by channel."""
    from repro_torch.core import gemm, stationary
    from repro_torch.core.precision import get_policy
    from repro_torch.obs import health

    t_phase = time.perf_counter()
    model = published_model(SEAMLESS_ARCH, SEAMLESS_RRNS_LAYERS,
                            get_policy("mirage"))
    cfg = model.cfg
    per = seamless_per_step(cfg)
    frames_np, prompts_np = seamless_inputs(
        cfg, SEAMLESS_ROWS, SEAMLESS_RRNS_FRAMES, SEAMLESS_PROMPT)
    frames = torch.from_numpy(frames_np).to(DEV)
    prompts = torch.from_numpy(prompts_np).to(DEV)
    rows, streams, launches_by = {}, {}, {}
    for name, policy in (("rrns_52db", get_policy(
            "mirage_rrns", snr_db=SNR_DB, noise_seed=NOISE_SEED)),
            ("rrns_clean", get_policy("mirage_rrns",
                                      noise_seed=NOISE_SEED))):
        model.policy = policy
        t0 = time.perf_counter()
        stationary.install(model, stationary.encode_stationary_params(
            model, policy))
        torch.cuda.synchronize()
        program_s = time.perf_counter() - t0
        encoded = [m.stationary for m in model.modules()
                   if getattr(m, "stationary", None) is not None]
        residue_gb = sum(e.residues.numel() * e.residues.element_size()
                         for e in encoded) / 1e9
        n_encoded = len(encoded)
        del encoded
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        acc = health.init(health.spec(policy), DEV)
        gen = torch.Generator(device=DEV).manual_seed(NOISE_SEED)

        @contextlib.contextmanager
        def scope():
            # the engine's plumbing around a model call: the GEMMs' noise
            # from one generator, the health records added into the
            # accumulators
            with gemm.noise_scope(gen), health.collect() as hc:
                yield
            health.fold(acc, hc.values)

        t0 = time.perf_counter()
        with BlockTap() as tap, RecordTap() as rec:
            toks = seamless_greedy(model, frames, prompts,
                                   SEAMLESS_RRNS_TOKENS, SEAMLESS_CAP,
                                   scope)[0]
        dt = time.perf_counter() - t0
        counters = {k: v.cpu().tolist() for k, v in acc.items()}
        launches = dict(ops.LAUNCHES)
        kernel = "rns_matmul_channel" if name == "rrns_52db" \
            else "rns_matmul"
        want = {kernel: tap.blocks, "rrns_decode": tap.blocks,
                "flash_attention": per["flash_prefill"]}
        calls = per["prefill"] + per["decode"] * (SEAMLESS_RRNS_TOKENS - 1)
        rows[name] = {"launches": launches, "expected_launches": want,
                      "residue_blocks": tap.blocks,
                      "gemm_calls_health_counted": tap.counted_calls,
                      "expected_gemm_calls": calls,
                      "health_records": rec.records,
                      "residue_blocks_health_counted": tap.counted_blocks,
                      "health": counters, "seconds": dt,
                      "program_weights_s": program_s,
                      "stationary_weights": n_encoded,
                      "stationary_residues_gb": residue_gb,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        streams[name] = toks.cpu().tolist()
        expect_launches(launches, want, f"slice_seamless_rrns {name}")
        check(tap.counted_calls == calls and tap.suppressed_calls == 0 and
              rec.records == tap.counted_blocks,
              f"slice_seamless_rrns {name}: {tap.counted_calls} GEMM calls "
              f"counted in the health scope, expected {calls}; "
              f"{rec.records} records for {tap.counted_blocks} blocks")
        check(all(0 <= t < cfg.vocab_size for r in streams[name]
                  for t in r), f"slice_seamless_rrns {name}: a token "
                               f"outside the vocabulary")
        launches_by[name] = launches
        stationary.install(model, None)
        free_card()
    counters = rows["rrns_52db"]["health"]
    equal = streams["rrns_52db"] == streams["rrns_clean"]
    emit({"phase": "slice_seamless_rrns", "arch": SEAMLESS_ARCH,
          "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.n_layers, "frames": SEAMLESS_RRNS_FRAMES,
          "prompt_len": SEAMLESS_PROMPT, "tokens": SEAMLESS_RRNS_TOKENS,
          "snr_db": SNR_DB, "noise_seed": NOISE_SEED, **rows,
          "streams_equal_clean": equal,
          "phase_seconds": time.perf_counter() - t_phase})
    check(counters["rrns_uncorrected"] == 0,
          f"slice_seamless_rrns: {counters['rrns_uncorrected']} decodes "
          f"beyond the correction radius at {SNR_DB} dB")
    check(equal, "slice_seamless_rrns: the 52 dB streams differ from the "
                 "clean channel's")
    del model, frames, prompts
    free_card()
    return launches_by


def _exact_dense(p, x):
    y = x @ p.w
    return y if p.b is None else y + p.b


def _exact_layernorm(p, x, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p.scale + p.bias


def _exact_rope(x, pos, theta: float):
    from repro_torch.models import common

    freqs = common.rope_freqs(x.shape[-1], theta, x.device).to(x.dtype)
    ang = pos.to(x.dtype)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _exact_attention(cfg, p, x, src, pos, causal: bool):
    """Softmax attention written out: self-attention with rope over ``x``
    where ``src`` is None, else cross-attention over ``src`` without rope,
    every key valid; query head h reads kv head h // (H // Kv)."""
    B, L, _ = x.shape
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kv = x if src is None else src
    S = kv.shape[1]
    q = _exact_dense(p.q, x).reshape(B, L, H, D)
    k = _exact_dense(p.k, kv).reshape(B, S, Kv, D)
    v = _exact_dense(p.v, kv).reshape(B, S, Kv, D)
    if src is None:
        q, k = (_exact_rope(t, pos, cfg.rope_theta) for t in (q, k))
    k, v = (t.repeat_interleave(H // Kv, dim=2) for t in (k, v))
    s = torch.einsum("blhd,bshd->bhls", q, k) / math.sqrt(D)
    if causal:
        s = s.masked_fill(torch.ones(L, S, dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    o = torch.einsum("bhls,bshd->blhd", torch.softmax(s, dim=-1), v)
    return _exact_dense(p.o, o.reshape(B, L, H * D))


def _exact_mlp(p, x):
    return _exact_dense(p.down, torch.nn.functional.gelu(
        _exact_dense(p.up, x), approximate="tanh"))


def exact_enc_layer(cfg, layer, h, pos):
    """The enc-dec model's encoder layer written out in plain tensor ops
    (LayerNorm, the family's), for an f64 reference of its gradients."""
    eps = cfg.norm_eps
    h = h + _exact_attention(cfg, layer.attn,
                             _exact_layernorm(layer.ln1, h, eps), None, pos,
                             causal=False)
    return h + _exact_mlp(layer.mlp, _exact_layernorm(layer.ln2, h, eps))


def exact_dec_layer(cfg, layer, h, pos, enc_out):
    """The decoder layer written out as :func:`exact_enc_layer`."""
    eps = cfg.norm_eps
    h = h + _exact_attention(cfg, layer.self_attn,
                             _exact_layernorm(layer.ln1, h, eps), None, pos,
                             causal=True)
    h = h + _exact_attention(cfg, layer.cross_attn,
                             _exact_layernorm(layer.ln_x, h, eps), enc_out,
                             pos, causal=False)
    return h + _exact_mlp(layer.mlp, _exact_layernorm(layer.ln2, h, eps))


def seamless_unit_grads(m, frames, inputs, enc_out, dec_layers, dev,
                        exact: bool = False):
    """Gradients of the enc-dec model ``m``'s teacher-forced units, by unit
    and leaf: ``frontend_proj`` with encoder layer 0 after it (over
    ``frames``), and each decoder layer of ``dec_layers`` (its input
    ``inputs[li]``, the encoder's output ``enc_out``), each unit's output
    against one seeded upstream gradient. ``m`` holds the decoder layers
    in ``dec_layers``' order (a shell of them), or a stack that reaches
    each of them. Through the port's own layers under ``m``'s policy, or
    with ``exact`` through :func:`exact_enc_layer` /
    :func:`exact_dec_layer` in ``m``'s dtype."""
    from repro_torch.models import common

    dt = next(m.parameters()).dtype
    pos = torch.arange(frames.shape[1], device=dev)
    if exact:
        x = _exact_dense(m.frontend_proj, frames.to(dev, dt))
        outs = [exact_enc_layer(m.cfg, m.enc_layers[0], x, pos)]
    else:
        x = common.dense(m.frontend_proj, frames.to(dev, dt), m.policy)
        outs = [m.enc_layer(m.enc_layers[0], x, pos)]
    units = {"frontend_proj+enc_layers.0": [
        (f"frontend_proj.{n}", q)
        for n, q in m.frontend_proj.named_parameters()] + [
        (f"enc_layers.0.{n}", q)
        for n, q in m.enc_layers[0].named_parameters()]}
    whole = len(m.dec_layers) > max(dec_layers)
    for i, li in enumerate(dec_layers):
        layer = m.dec_layers[li if whole else i]
        h, e = inputs[li].to(dev, dt), enc_out.to(dev, dt)
        outs.append(exact_dec_layer(m.cfg, layer, h, pos, e) if exact
                    else m.dec_layer(layer, h, pos, e)[0])
        units[f"dec_layers.{li}"] = [(f"dec_layers.{li}.{n}", q)
                                     for n, q in layer.named_parameters()]
    gen = torch.Generator(device="cpu").manual_seed(11)
    douts = [torch.randn(o.shape, generator=gen).to(dev, dt) for o in outs]
    named = [nq for unit in units.values() for nq in unit]
    g = torch.autograd.grad(outs, [q for _, q in named], douts)
    got = {n: x.cpu() for (n, _), x in zip(named, g)}
    return {u: {n: got[n] for n, _ in unit} for u, unit in units.items()}


def seamless_grads_vs_cpu(model, batch, dec_layers):
    """fp32 gradients on the card against the CPU's and against an f64
    reference on the CPU, teacher-forced, every side fed the card's inputs
    and one seeded upstream gradient a unit (:func:`seamless_unit_grads`:
    ``frontend_proj`` with encoder layer 0, and each decoder layer of
    ``dec_layers``). The f64 side runs the same weights through the layers
    written out in plain tensor ops. Returns, by unit and leaf, the card's
    and the CPU's relative L2 distances from the f64 gradient, the card's
    from the CPU's, the leaf's largest gradient over its unit's, and the
    card's gate: its distance from f64 within LAYER_GRAD_RTOL or within
    SEAMLESS_GRAD_F64_MARGIN times the CPU's, whichever is larger; a leaf
    whose gradient is 0 in exact arithmetic (SEAMLESS_ZERO_GRAD) is held
    instead to 1e-6 of its unit's largest gradient, on the card and in
    f64."""
    from repro_torch.core.precision import get_policy
    from repro_torch.models import common

    fp32 = get_policy("fp32")
    policy0 = model.policy
    model.policy = fp32
    shell = encdec_shell(model, (0,), dec_layers, policy=fp32)
    exact = copy.deepcopy(shell).double()
    frames = torch.from_numpy(batch["frames"]).to(DEV)
    toks = torch.from_numpy(batch["tokens"]).to(DEV)
    pos = torch.arange(toks.shape[1], device=DEV)
    inputs = {}
    with torch.no_grad():
        enc_out = model.encode(frames)
        h = common.embed(model.embed, toks)
        for li, layer in enumerate(model.dec_layers[:max(dec_layers) + 1]):
            inputs[li] = h
            h = model.dec_layer(layer, h, pos, enc_out)[0]
    grads = {side: seamless_unit_grads(m, frames, inputs, enc_out,
                                       dec_layers, dev, exact=side == "f64")
             for side, m, dev in (("card", model, DEV), ("cpu", shell, "cpu"),
                                  ("f64", exact, "cpu"))}
    model.policy = policy0
    del shell, exact, inputs, enc_out
    out = {}
    for unit, want in grads["f64"].items():
        top = max(float(v.abs().max()) for v in want.values())
        out[unit] = {}
        for n, v in want.items():
            card, cpu = grads["card"][unit][n], grads["cpu"][unit][n]
            e = {"card_vs_f64": rel_l2(card, v), "cpu_vs_f64": rel_l2(cpu, v),
                 "card_vs_cpu": rel_l2(card, cpu),
                 "scale": float(v.abs().max()) / top}
            if n.endswith(SEAMLESS_ZERO_GRAD):
                e["card_max_over_unit_max"] = float(card.abs().max()) / top
                e["ok"] = max(e["card_max_over_unit_max"], e["scale"]) <= \
                    SEAMLESS_ZERO_GRAD_ATOL
            else:
                e["limit"] = max(LAYER_GRAD_RTOL,
                                 SEAMLESS_GRAD_F64_MARGIN * e["cpu_vs_f64"])
                e["ok"] = e["card_vs_f64"] <= e["limit"]
            out[unit][n] = e
    return out


def phase_slice_train_seamless(ops):
    """seamless-m4t-large-v2 at full width and depth trained as ``python
    -m repro_torch.launch.train --arch seamless-m4t-large-v2`` trains it:
    SEAMLESS_TRAIN_STEPS steps of batch 4 x 64 with the frames
    ``with_extras`` draws (one a token), AdamW lr 1e-3, clip 1.0, mirage;
    every forward, dX and dW GEMM one launch of kernel 1 (3 x 386 - 1 a
    step: the frames take no dX; attention plain, as the JAX package
    trains it), finite losses; step time, tokens/s, the share of model
    FLOPs, peak memory and the step's split; two steps from one state
    bitwise equal; frontend_proj's, encoder layer 0's and decoder layers
    0's and 23's fp32 gradients teacher-forced, each leaf held against an
    f64 reference at its own scale beside the CPU's f32
    (:func:`seamless_grads_vs_cpu`)."""
    from repro_torch.core.precision import get_policy
    from repro_torch.data.pipeline import with_extras

    t_phase = time.perf_counter()
    cfg, model, tc, data = train_setup(get_policy("mirage"), SEAMLESS_ARCH)
    data = with_extras(data, cfg)
    per_step = seamless_per_step(cfg)["train"]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, step, times, logs = run_train(model, tc, data,
                                         SEAMLESS_TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    gemm_w = sum(m.w.numel() for m in model.modules() if hasattr(m, "w"))
    flops = 6.0 * gemm_w * tokens
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    finite = all(math.isfinite(v) for v in losses + norms)
    want = {"mirage_gemm": per_step * SEAMLESS_TRAIN_STEPS}
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": "slice_train_seamless", "arch": SEAMLESS_ARCH,
          "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.n_layers, "params": n_params,
          "gemm_weights": gemm_w, "train_state_gb": 16.0 * n_params / 1e9,
          "policy": "mirage (mirage_fast b_m=4 g=16 k=5)",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "frames": "with_extras: (4, 64, 1024) f32 normals a batch",
          "steps": SEAMLESS_TRAIN_STEPS,
          "optimizer": "adamw lr=1e-3 clip=1.0",
          "gemm_per_step": per_step, "launches": launches,
          "expected_launches": want,
          "step_ms": [t * 1e3 for t in times],
          "step_ms_median_2_on": step_s * 1e3, "tok_per_s": tokens / step_s,
          "peak_mem_gb": peak, "build_model_s": build_s,
          "model_flops_per_step": flops,
          "model_flops_note": "6 x GEMM weights x tokens (the encoder over "
                              "64 frames a row); attention's FLOPs are "
                              "left out",
          "model_flops_share_of_989_tflops": flops / step_s /
          BF16_FLOPS_PER_S, "losses": losses, "grad_norms": norms})
    check(finite, f"slice_train_seamless: a loss or grad norm is not "
                  f"finite: {losses} {norms}")
    expect_launches(launches, want, "slice_train_seamless")
    prof = device_profile(lambda: step(state, next(data)), 1, host=False)
    emit({"phase": "slice_train_seamless_profile", "steps": 1, **{
        k.replace("_ms", "_ms_per_step"): v for k, v in prof.items()},
        "gemm_ms_per_step": gemm_share(prof)})
    emit({"phase": "slice_train_seamless_breakdown", "steps": 2,
          **step_breakdown(model, tc, state, data, 2)})
    del state
    free_card()
    batch = {k: np.asarray(v) for k, v in next(data).items()}
    losses2, digests = repeat_step(model, batch)
    same = bool(torch.equal(losses2[0].view(torch.int32),
                            losses2[1].view(torch.int32))) and \
        digests[0] == digests[1]
    check(same, f"slice_train_seamless: two steps from one state differ: "
                f"{[float(v) for v in losses2]} {digests}")
    free_card()
    t0 = time.perf_counter()
    dec_layers = (0, cfg.n_layers - 1)
    errs = seamless_grads_vs_cpu(model, batch, dec_layers)
    failed = {f"{unit} {n}": e for unit, leaves in errs.items()
              for n, e in leaves.items() if not e["ok"]}
    emit({"phase": "slice_train_seamless_checks",
          "repeat_losses": [float(v) for v in losses2],
          "repeat_grad_digests": digests, "repeat_bitwise_equal": same,
          "fp32_grads": errs,
          "fp32_grads_worst": {unit: {
              k: max(e[k] for e in leaves.values() if "limit" in e)
              for k in ("card_vs_f64", "cpu_vs_f64", "card_vs_cpu")}
              for unit, leaves in errs.items()},
          "fp32_grads_rtol": LAYER_GRAD_RTOL,
          "fp32_grads_f64_margin": SEAMLESS_GRAD_F64_MARGIN,
          "fp32_grads_note": "relative L2 of each leaf's card and CPU f32 "
                             "gradients from an f64 reference on the CPU "
                             "(the same weights and inputs through the "
                             "layers written out in plain tensor ops); the "
                             "gate: card_vs_f64 <= max(rtol, margin x "
                             "cpu_vs_f64), and the cross-attention key "
                             "bias (0 in exact arithmetic; left out of "
                             "the worst values) within "
                             f"{SEAMLESS_ZERO_GRAD_ATOL} of its unit's "
                             "largest gradient",
          "fp32_grads_failed": sorted(failed),
          "cpu_seconds": time.perf_counter() - t0, "ok": not failed,
          "phase_seconds": time.perf_counter() - t_phase})
    check(not failed, f"slice_train_seamless: fp32 gradients of "
                      f"frontend_proj, encoder layer 0 or decoder layers "
                      f"{dec_layers} on the card are further from the f64 "
                      f"reference than the gate allows: {failed}")
    del model
    free_card()
    return launches


# --------------------------------------------------------------------------
# slice 8a: sharded training (FSDP x TP over a 2x2 mesh), expert-parallel
# MoE and elastic restore, as 4 ranks on the one card over gloo
# --------------------------------------------------------------------------

#: the mesh of the slice-8 phases: 4 ranks on the one card (NCCL takes one
#: rank a card, so the ranks meet over gloo, passed explicitly)
SLICE8_MESH, SLICE8_BACKEND = (2, 2), "gloo"
SLICE8_STEPS = 3
#: the elastic phase's depth cut (of 24 layers): its checkpoint is written
#: once and read by 5 processes inside the script's time limit
ELASTIC_LAYERS = 2
#: the EP phase: qwen3-moe-30b-a3b at full width, its first layer; x is 4 x
#: 64 tokens (128 a data rank)
MOE_EP_BATCH = (4, 64)
#: qwen2-0.5b's GEMMs at TP = 2, in the order a layer calls them: (K, N) of
#: the local shard (q 896 -> 448, k/v -> 64, o 448 -> 896, gate/up 896 ->
#: 2,432, down 2,432 -> 896) and the tied head's vocab shard
SHARD_LAYER_KN = ((896, 448), (896, 64), (896, 64), (448, 896),
                  (896, 2432), (896, 2432), (2432, 896))
SHARD_HEAD_KN = (896, 75968)
#: the kernel-1 rows at the shard shapes (row 1h): M = 256 (B x L of one
#: device), and M = 128 (a data rank's tokens on the 2x2 mesh)
SHARD_M = (128, 256)
SHARD_TIMED = ((896, 2432), (2432, 896))
#: the mirage 2x2 step 1 against one device's. The forward differs from
#: one device's only in f32 sum orders (the row-parallel o and down GEMMs
#: end in a sum over 2 ranks; the vocab-parallel cross-entropy sums its
#: exponentials per shard), where a BFP model flips a rounding wherever a
#: last-bit difference crosses a grid midpoint (ROADMAP's parity contract).
#: The loss limit is test_torch_train's step-one bound, 12x the largest
#: sound reading (7.9e-8 on the H100, PERF.md); the phase also reads the
#: loss that a data rank left out of the mean would give (each data rank's
#: own mean) and fails unless that lies above the limit.
SLICE8_MIRAGE_LOSS_TOL = 1e-6
#: The step-1 gradients leaf by leaf (relative L2 over the whole leaf).
#: fp32 holds every leaf to 1e-5; under mirage an f32-order difference
#: flips BFP roundings of the backward's quantized operands, and each layer
#: the backward passes compounds the flips: the H100's readings grow from
#: 7.9e-7 (final_norm.scale, one quantized GEMM from the loss) and 9.5e-3
#: (layer 23) to 0.197 (layer 0), while the planted fault (a data rank's
#: rows alone, the other left out of the mean) puts every leaf at
#: 0.70-1.0. The limits sit between: SLICE8_MIRAGE_GRAD_TOL on every leaf,
#: the CPU test's 1e-5 on SLICE8_MIRAGE_HEAD_LEAF; the phase fails unless
#: the fault lies above both.
SLICE8_MIRAGE_GRAD_TOL = 0.35
SLICE8_MIRAGE_HEAD_LEAF, SLICE8_MIRAGE_HEAD_TOL = "final_norm.scale", 1e-5
#: AdamW's first step moves a parameter by lr * g / (|g| + 1e-8): where |g|
#: >= 1e-6 that is +-lr within 1%, and a gradient off by its f32 order
#: moves it by ~10 x that error; below, the step's slope (lr * 1e-8 / (|g|
#: + 1e-8)^2, up to lr / 4e-8 at |g| = 1e-8) turns the same error into a
#: sizeable share of lr. The fp32 params gate (5e-5, the JAX test's) holds
#: where |g| >= SLICE8_ADAM_G; the rest are counted and reported.
SLICE8_ADAM_G = 1e-6


def _dsync() -> None:
    if DEV != "cpu":
        torch.cuda.synchronize()


def _free() -> None:
    import gc
    gc.collect()
    if DEV != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if DEV != "cpu" else 0.0


class GemmShapeTap:
    """The (M, K, N) of every 2-D launch of kernel 1 while open (a wrapper
    around ``ops.mirage_matmul_fused``, which the mirage backend calls)."""

    def __init__(self, ops):
        self.ops, self.shapes = ops, []

    def __enter__(self):
        inner = self.inner = self.ops.mirage_matmul_fused

        def tapped(x, w, *a, **k):
            if w.dim() == 2:
                self.shapes.append((x.numel() // x.shape[-1],
                                    int(w.shape[0]), int(w.shape[1])))
            return inner(x, w, *a, **k)
        self.ops.mirage_matmul_fused = tapped
        return self

    def __exit__(self, *exc):
        self.ops.mirage_matmul_fused = self.inner


def shard_cases():
    """(gemm, M, a, b) operands of kernel 1 at the 2x2 step's local shard
    shapes: each layer GEMM's forward, dX and dW, and the head's."""
    for M in SHARD_M:
        for i, (K, N) in enumerate(sorted(set(SHARD_LAYER_KN))
                                   + [SHARD_HEAD_KN]):
            gen = torch.Generator(device=DEV).manual_seed(800 + i + M)
            x = torch.randn((M, K), generator=gen, device=DEV)
            dout = torch.randn((M, N), generator=gen, device=DEV) * 1e-2
            if (K, N) == SHARD_HEAD_KN:
                w = (torch.randn((N, K), generator=gen, device=DEV)
                     * 0.02).T
            else:
                w = torch.randn((K, N), generator=gen, device=DEV) / \
                    math.sqrt(K)
            yield "fwd", M, K, N, x, w
            yield "dX", M, K, N, dout, w.T
            yield "dW", M, K, N, x.T, dout


def phase_slice8_kernels(ops, ref, policy):
    """Kernel 1 at every shard shape of the 2x2 step (M = 128) and of one
    device's batch (M = 256) against its plain version within the f32-order
    bound, bitwise repeatable; row 1h: gate/up and down with their dX and
    dW timed beside the plain version, ``torch.matmul`` on the pre-folded
    operands and the bound."""
    worst, rows = 0.0, []
    for name, M, K, N, a, b in shard_cases():
        got = ops.mirage_matmul_fused(a, b, policy)
        again = ops.mirage_matmul_fused(a, b, policy)
        want = ref.mirage_gemm_ref(a, b, policy.b_m, policy.g)
        tol = gemm_bound(ref, a, b)
        err = (got - want).abs()
        bad = int((err > tol).sum())
        same = bool(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)))
        Mc, Kc, Nc = a.shape[0], a.shape[1], b.shape[1]
        plan = card_gemm_plan(ops, Mc, Kc, Nc, policy.b_m)
        row = {"gemm": name, "tokens": M, "layer_K": K, "layer_N": N,
               "M": Mc, "K": Kc, "N": Nc, "weight_read": weight_read(b),
               "route": "mma_bf16" if plan.mma else "decode_f32",
               "splits": plan.splits, "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol).max()),
               "bitwise_repeatable": same}
        check(bad == 0, f"kernel 1 outside its bound in {bad} elements at "
                        f"the shard shape {name} M={M} K={K} N={N}")
        check(same, f"two launches of kernel 1 differ at the shard shape "
                    f"{name} M={M} K={K} N={N}")
        worst = max(worst, float(err.max()))
        if (K, N) in SHARD_TIMED:
            aq = ref.bfp_fake_quant_ref(a, policy.b_m, policy.g)
            bq = ref.bfp_fake_quant_ref(b.T, policy.b_m, policy.g).T
            t_b, by = bound_rate(4.0 * (Mc * Kc + Kc * Nc + Mc * Nc),
                                 2.0 * Mc * Nc * Kc,
                                 BF16_FLOPS_PER_S if plan.mma
                                 else F32_FLOPS_PER_S)
            row.update(
                ms=time_ms(lambda: ops.mirage_matmul_fused(a, b, policy)),
                plain_ms=time_ms(lambda: ref.mirage_gemm_ref(
                    a, b, policy.b_m, policy.g), **PLAIN_TIMING),
                library_ms=time_ms(lambda: torch.matmul(aq, bq)),
                library="torch.matmul on the pre-folded operands",
                bound_ms=t_b, bound_by=by)
            rows.append(row)
            del aq, bq
        emit({"phase": "gemm_shard_vs_plain", **row})
        del a, b, got, again, want, tol, err
    for row in rows:
        emit({"phase": "timing", "kernel": "mirage_gemm", "path": "slice_8",
              **row})
    return rows, worst


class StepTap:
    """What a train step computes inside, while open: its gradients (summed
    over the data ranks, before compression and clipping: what
    ``runtime.trainer._reduce_grads`` returns in every step) and, on a
    mesh, the rank's own loss before the mean over the data ranks (the
    first value ``runtime.trainer._global_mean`` takes)."""

    def __init__(self):
        from repro_torch.runtime import trainer
        self.trainer, self.grads, self.local_loss = trainer, None, None

    def __enter__(self):
        reduce_grads, global_mean = self.inner = (
            self.trainer._reduce_grads, self.trainer._global_mean)

        def tapped_reduce(*a, **k):
            self.grads = reduce_grads(*a, **k)
            return self.grads

        def tapped_mean(t, comm):
            if self.local_loss is None:
                self.local_loss = t.detach().clone()
            return global_mean(t, comm)
        self.trainer._reduce_grads = tapped_reduce
        self.trainer._global_mean = tapped_mean
        return self

    def __exit__(self, *exc):
        self.trainer._reduce_grads, self.trainer._global_mean = self.inner


def _single_steps(policy, batches, pls, fault_rows=None):
    """The single-device port's steps on the global ``batches``: this
    rank's slices (by the 2x2 placements ``pls``) of step 1's gradients
    and of the params after it, and every step's loss. With
    ``fault_rows``, first the planted fault: the gradient of step 1's loss
    over those rows alone (a data rank's rows, the others left out of the
    mean), its slices at ``pls``."""
    from repro_torch.runtime.trainer import init_train_state, make_train_step

    _, ref, tc, _ = train_setup(policy)
    fault = None
    if fault_rows is not None:
        part = {k: torch.as_tensor(v[fault_rows]).to(DEV)
                for k, v in batches[0].items()}
        names = list(pls)
        loss, _ = ref.loss(part)
        g = torch.autograd.grad(loss, [ref.get_parameter(k)
                                       for k in names])
        fault = {k: pls[k].local(v).clone() for k, v in zip(names, g)}
        del loss, g, part
    step = make_train_step(ref, tc)
    state = init_train_state(ref, tc)
    losses = []
    for i, batch in enumerate(batches):
        with StepTap() as tap:
            state, metrics = step(state, batch)
        if i == 0:
            grads = {k: pls[k].local(g).clone()
                     for k, g in tap.grads.items()}
            params = {k: pls[k].local(p).detach().clone()
                      for k, p in state["params"].items()}
        losses.append(float(metrics["loss"]))
        del tap
    del ref, state, step, metrics
    _free()
    return grads, params, losses, fault


def _grad_rel_l2(got, want, pls, comm):
    """Each gradient leaf's relative L2 distance over the whole leaf, from
    the ranks' shards (the sums of squares meet over the ranks, a
    replicated shard counted once): (the worst, its leaf, {leaf:
    distance})."""
    names = list(pls)
    sq = torch.zeros((2, len(names)), dtype=torch.float64, device=DEV)
    with torch.no_grad():
        for i, k in enumerate(names):
            g = want[k].double()
            sq[0, i] = torch.sum((got[k].double() - g) ** 2)
            sq[1, i] = torch.sum(g ** 2)
            sq[:, i] /= pls[k].replicas
    sq = comm.all_reduce(sq, "world")
    rel = torch.sqrt(sq[0] / torch.clamp_min(sq[1], 1e-300)).tolist()
    worst = max(range(len(names)), key=rel.__getitem__)
    return rel[worst], names[worst], dict(zip(names, rel))


def _slice8_train(rank, comm, ops, out_dir):
    """The 2x2 step of full-width qwen2-0.5b under mirage (SLICE8_STEPS
    steps; step 1's gradient shards kept on the host, so the peak memory
    is the steps' own) against the single-device steps on the same global
    batches: then every rank runs the single-device step 1 and keeps its
    slices of the gradients (no shard leaves its rank), rank 0 all the
    steps for the losses. Then one fp32 step of each, held the same way,
    the params too."""
    from repro_torch.core.precision import get_policy
    from repro_torch.parallel.shard import local_batch
    from repro_torch.runtime.trainer import init_train_state, make_train_step

    out = {}
    policy = get_policy("mirage")
    cfg, model, tc, data = train_setup(policy)
    data = iter(data)
    batches = [next(data) for _ in range(SLICE8_STEPS)]
    step = make_train_step(model, tc, mesh=comm)
    pls = model.placements
    state = init_train_state(model, tc)
    _dsync()
    if DEV != "cpu":
        torch.cuda.reset_peak_memory_stats()
    times, launches, stats, losses, shapes = [], [], [], [], []
    for i, batch in enumerate(batches):
        comm.stats.reset()
        ops.reset_launch_counts()
        with GemmShapeTap(ops) as tap, StepTap() as step_tap:
            _dsync()
            t0 = time.perf_counter()
            state, metrics = step(state, local_batch(batch, comm))
            _dsync()
            times.append(time.perf_counter() - t0)
        launches.append(dict(ops.LAUNCHES))
        stats.append(comm.stats.as_dict())
        losses.append(float(metrics["loss"]))
        shapes.append(tap.shapes)
        if i == 0:
            got_g = {k: g.to("cpu") for k, g in step_tap.grads.items()}
            local_loss = float(step_tap.local_loss)
        del step_tap
    out.update(step_s=times, launches=launches, comm=stats, losses=losses,
               shapes=shapes, peak_gb=_peak_gb(),
               params=sum(p.numel() for p in model.parameters()),
               full_params=sum(math.prod(pl.shape)
                               for pl in model.placements.values()),
               layers=cfg.n_layers, local_loss=local_loss,
               dp_rank=comm.dp_rank)
    del model, state, step
    _free()
    comm.barrier()
    # the planted fault: data rank 0's rows alone (batch rows 0 and 1)
    want_g, _, single_losses, fault_g = _single_steps(
        policy, batches if rank == 0 else batches[:1], pls,
        fault_rows=slice(0, TRAIN_BATCH // SLICE8_MESH[0]))
    if rank == 0:
        out["single_losses"] = single_losses
    got_g = {k: g.to(DEV) for k, g in got_g.items()}
    rel, leaf, by_leaf = _grad_rel_l2(got_g, want_g, pls, comm)
    out["mirage_grads"] = {"grad_rel_l2_max": rel,
                           "grad_rel_l2_worst_leaf": leaf,
                           "leaves": len(pls), "by_leaf": by_leaf,
                           "fault_by_leaf": _grad_rel_l2(
                               fault_g, want_g, pls, comm)[2]}
    del got_g, want_g, fault_g
    _free()
    comm.barrier()

    # fp32 (the backend pins TF32 off): one step of each, held leaf by
    # leaf, the sums and maxima meeting over the ranks, each shard counted
    # once.
    fp32 = get_policy("fp32")
    cfg, model, tc, _ = train_setup(fp32)
    step = make_train_step(model, tc, mesh=comm)
    pls = model.placements
    want_g, want_p, (want_loss,), _ = _single_steps(fp32, batches[:1],
                                                    pls)
    state = init_train_state(model, tc)
    with StepTap() as step_tap:
        state, metrics = step(state, local_batch(batches[0], comm))
    loss = float(metrics["loss"])
    rel, leaf, _ = _grad_rel_l2(step_tap.grads, want_g, pls, comm)
    del step_tap
    hi = torch.zeros(4, dtype=torch.float64, device=DEV)
    with torch.no_grad():
        for k in pls:
            d = (state["params"][k] - want_p[k]).abs().double()
            g = want_g[k].double().abs()
            off = d > 5e-5
            zero = torch.zeros_like(g)
            hi[0] = torch.maximum(hi[0], d.max())
            hi[1] = torch.maximum(hi[1], torch.where(off, g, zero).max())
            hi[2] = torch.maximum(hi[2], torch.where(
                g >= SLICE8_ADAM_G, d, zero).max())
            hi[3] += off.sum()
    hi[:3] = comm.all_reduce(hi[:3], "world",
                             op=torch.distributed.ReduceOp.MAX)
    hi[3] = comm.all_reduce(hi[3:], "world")[0]
    out["fp32"] = {"loss": loss, "single_loss": want_loss,
                   "loss_rel": abs(loss - want_loss) / abs(want_loss),
                   "grad_rel_l2_max": rel,
                   "grad_rel_l2_worst_leaf": leaf,
                   "param_max_abs": float(hi[0]),
                   "params_off_over_5e-5_rank_sum": float(hi[3]),
                   "their_grad_abs_max": float(hi[1]),
                   "param_max_abs_where_grad_ge_1e-6": float(hi[2])}
    del model, state, step, want_g, want_p
    _free()
    comm.barrier()
    return out


def _slice8_moe_ep(rank, comm, ops, out_dir):
    """``moe_apply_ep`` over the 2x2 mesh at full width (qwen3-moe-30b-a3b,
    layer 0: 128 experts, 64 a rank), dropless and at capacity 1.25, with
    its backward; each data shard's first rank holds it against the
    single-device ``moe_apply``."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models import build_model, moe
    from repro_torch.models.lm import LMCallOptions
    from repro_torch.parallel.shard import local_rows, shard_model

    policy = get_policy("mirage")
    cfg = dataclasses.replace(
        get_config("qwen3-moe-30b-a3b").reduced() if REDUCED
        else get_config("qwen3-moe-30b-a3b"), n_layers=1)
    model = build_model(cfg, policy, LMCallOptions(moe_impl="ep_shard_map"),
                        device=DEV, generator=torch.Generator(
                            device=DEV).manual_seed(0))
    leader = comm.tp_rank == 0
    ref_moe = copy.deepcopy(model.layers[0].moe) if leader else None
    shard_model(model, comm)
    layer = model.layers[0].moe
    gen = torch.Generator(device=DEV).manual_seed(5)
    x = torch.randn(MOE_EP_BATCH + (cfg.d_model,), generator=gen,
                    device=DEV)
    r = torch.randn(MOE_EP_BATCH + (cfg.d_model,), generator=gen,
                    device=DEV)
    names = ("router.w", "gate", "up", "down")
    params = [layer.router.w, layer.gate, layer.up, layer.down]
    kw = dict(n_experts=cfg.n_experts,
              experts_per_token=cfg.experts_per_token)
    out = {"experts_local": int(layer.gate.shape[0]),
           "experts": cfg.n_experts, "tokens_local": int(
               local_rows(x, comm).shape[0] * x.shape[1])}
    for factor in (8.0, 1.25):
        xl = local_rows(x, comm).clone().requires_grad_(True)
        ops.reset_launch_counts()
        _dsync()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply_ep(layer, xl, policy, capacity_factor=factor,
                                  comm=comm, **kw)
        grads = torch.autograd.grad(
            torch.sum(y * local_rows(r, comm)) + aux / comm.dp,
            params + [xl])
        _dsync()
        res = {"seconds": time.perf_counter() - t0,
               "launches": dict(ops.LAUNCHES), "aux": float(aux),
               "grads_finite": all(bool(torch.isfinite(g).all())
                                   for g in grads),
               "grad_norms": {n: float(g.norm())
                              for n, g in zip(names + ("x",), grads)}}
        if leader:
            with torch.no_grad():
                full = moe.moe_apply(ref_moe, x, policy,
                                     capacity_factor=factor, **kw)
                own = moe.moe_apply(ref_moe, local_rows(x, comm), policy,
                                    capacity_factor=factor, **kw)
            T = xl.shape[0] * xl.shape[1]
            C = moe.capacity(T, cfg.n_experts, cfg.experts_per_token,
                             factor)
            with torch.no_grad():
                rt = moe.route(ref_moe.router, local_rows(x, comm).reshape(
                    T, -1), cfg.experts_per_token, C)
            want = local_rows(full[0], comm) if factor == 8.0 else own[0]
            res.update(
                dropped_local=int((~rt.keep).sum()),
                y_rel_max=float((y.detach() - want).abs().max()
                                / want.abs().max()),
                aux_vs_global=abs(float(aux) - float(full[1])),
                reference="moe_apply on the whole batch" if factor == 8.0
                else "moe_apply on the data shard alone")
        out[f"factor_{factor}"] = res
        del y, aux, grads, xl
    del model, ref_moe, layer, params
    _free()
    comm.barrier()
    return out


def _slice8_elastic(rank, comm, ops, out_dir):
    """One 2x2 step at ELASTIC_LAYERS of qwen2-0.5b's 24 layers, saved; the
    checkpoint restored onto a 1x4 mesh (the same 4 ranks) and, on rank 0,
    onto one device; every leaf compared bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.precision import get_policy
    from repro_torch.interop import (_by_name, restore_train_state,
                                     to_jax_train_state)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.comm import MeshComm
    from repro_torch.parallel.shard import (_tree, local_batch,
                                            state_placements)
    from repro_torch.runtime.trainer import init_train_state, make_train_step

    def diff(a, b):
        worst = 0.0
        for tree in ("params", "err"):
            for k in a.get(tree, {}):
                worst = max(worst, float((a[tree][k] - b[tree][k])
                                         .abs().max()))
        for mom in ("m", "v"):
            for k in a["opt"][mom]:
                worst = max(worst, float((a["opt"][mom][k] -
                                          b["opt"][mom][k]).abs().max()))
        return worst

    t0 = time.perf_counter()
    policy = get_policy("mirage")
    cfg, model, tc, data = train_setup(policy, n_layers=ELASTIC_LAYERS,
                                       grad_compression="bfp")
    step = make_train_step(model, tc, mesh=comm)
    state = init_train_state(model, tc)
    state, _ = step(state, local_batch(next(iter(data)), comm))
    ck = Checkpointer(str(out_dir / "ckpt"))
    t1 = time.perf_counter()
    jstate = to_jax_train_state(model, state)
    ck.save(jstate, step=1)
    save_s = time.perf_counter() - t1

    def by_name(tree):
        return {k: torch.from_numpy(v).to(DEV)
                for k, v in _by_name(model, tree).items()}
    # the saved whole state by the port's names, on the card
    saved = {"params": by_name(jstate["params"]),
             "err": by_name(jstate["err"]),
             "opt": {k: by_name(jstate["opt"][k]) for k in ("m", "v")}}
    del jstate, model, state, step
    out = {"layers": ELASTIC_LAYERS, "save_s": save_s}
    # onto 1x4: a fresh model (zeroed) on the same ranks, another mesh
    mesh14 = MeshComm(make_debug_mesh(1, 4, device=comm.device,
                                      backend=SLICE8_BACKEND), comm.device)
    _, model, tc, _ = train_setup(policy, n_layers=ELASTIC_LAYERS,
                                  grad_compression="bfp")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    make_train_step(model, tc, mesh=mesh14)
    state = init_train_state(model, tc)
    t1 = time.perf_counter()
    state, _ = restore_train_state(ck, model, state)
    out["restore_1x4_s"] = time.perf_counter() - t1
    # each rank's 1x4 shards against its slices of the saved whole state
    pls = state_placements(model, state)
    mine = {key: {k: pl.local(_tree(saved, key)[k])
                  for k, pl in tree.items()} for key, tree in pls.items()}
    got = {"params": state["params"], "err": state["err"],
           "opt": {"m": state["opt"]["m"], "v": state["opt"]["v"]}}
    want = {"params": mine["params"], "err": mine["err"],
            "opt": {"m": mine["opt/m"], "v": mine["opt/v"]}}
    out["q_shard_1x4"] = tuple(model.layers[0].attn.q.w.shape)
    out["o_shard_1x4"] = tuple(model.layers[0].attn.o.w.shape)
    out["diff_1x4"] = diff(want, got)
    out["step_1x4"] = int(state["step"])
    del model, state, got, want, mine
    if rank == 0:
        _, model, tc, _ = train_setup(policy, n_layers=ELASTIC_LAYERS,
                                      grad_compression="bfp")
        state = init_train_state(model, tc)
        state, _ = restore_train_state(ck, model, state)
        out["diff_1x1"] = diff(saved, state)
        out["step_1x1"] = int(state["step"])
        del model, state
    out["seconds"] = time.perf_counter() - t0
    del saved
    _free()
    comm.barrier()
    return out


# --------------------------------------------------------------------------
# slice 8b: meshed serving (LMServer(mesh=...)) at full width, in the
# slice-8 spawn: the weights cut over ``model``, the slots and the paged
# pools' blocks over ``data``
# --------------------------------------------------------------------------

#: the tokens every request of the phase shares at its head: one block, so
#: the prefix cache hits and, under round_robin, across the shards
SERVE8_PREFIX = 16
#: the mirage prefill held layer by layer, teacher-forced, against one
#: device's: each layer of the sharded model gets the one-device layer's
#: input, and its output's relative L2 distance from the one-device
#: output must stay under this. Set from the card's readings (PERF.md
#: §6): every layer reads 0.0 (BFP(4, 16) products and group sums are
#: exact in f32, so the row-parallel sum over 2 ranks lands on one
#: device's bits), a planted fault (layer 0 on the wrong kv head) 1.42;
#: the limit leaves room for a reordered f32 sum (~1e-7 a layer) and
#: stays five orders under the fault
SERVE8_LAYER_TOL = 1e-5
#: steady decode ticks that rank 0 profiles (the ranks tick in lockstep),
#: and the drains it profiles
SERVE8_PROFILE_TICKS = 2
SERVE8_PROFILED = ("mirage", "rrns_52db")
#: the meshed drains and the tokens a request of each (the slice's 32 for
#: fp32 on locality blocks; fewer elsewhere, for the script's time limit:
#: a gloo tick of 4 ranks on one card takes ~150 ms, ~350 under the
#: analog channel)
SERVE8_RUNS = {"fp32_locality": ("fp32", {}, MAX_TOKENS),
               "fp32_round_robin_prefix": ("fp32", dict(
                   block_placement="round_robin", prefix_cache=True), 16),
               "mirage": ("mirage", {}, 16),
               "rrns_52db": ("mirage_rrns", {}, 8)}
#: kernel 1 at the meshed decode tick's shard shapes: M = SLOTS / 2 slots a
#: data rank, (K, N) of the layer GEMMs at TP = 2 and the head's vocab
#: shard; the timed ones
SERVE8_M = SLOTS // SLICE8_MESH[0]
SERVE8_TIMED = ((896, 2432), (2432, 896), SHARD_HEAD_KN)
#: flash at the meshed prefill's shape: a rank's 7 of 14 q heads over its 1
#: of 2 kv heads (group 7), the slice's longest bucket
SERVE8_FLASH = (2, 128, 7, 1, 64)


def serve8_requests(Request, vocab: int, max_tokens: int = MAX_TOKENS):
    """The slice's 8 requests (17-128 prompt tokens, numpy seed 0) with a
    common first block of ``SERVE8_PREFIX`` tokens."""
    reqs = make_requests(Request, vocab, max_tokens)
    head = np.random.default_rng(1).integers(0, vocab, SERVE8_PREFIX)
    for r in reqs:
        r.prompt[:SERVE8_PREFIX] = head
    return reqs


def serve8_policy(pol: str):
    from repro_torch.core.precision import get_policy
    if pol == "mirage_rrns":
        return get_policy(pol, snr_db=SNR_DB, noise_seed=NOISE_SEED)
    return get_policy(pol)


def serve8_model(policy):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    cfg = get_config("qwen2-0.5b")
    cfg = cfg.reduced() if REDUCED else cfg
    return build_model(cfg, policy, LMCallOptions(use_flash_kernel=True),
                       device=DEV, generator=torch.Generator(
                           device=DEV).manual_seed(0))


def _kv_leaves(layer):
    """The k and v projections' parameters of ``layer`` by (module,
    leaf)."""
    return {(mod, leaf): t for mod in (layer.attn.k, layer.attn.v)
            for leaf, t in mod.named_parameters(recurse=False)}


def _teacher_forced_layers(model, tokens, mesh):
    """Each layer's prefill output on one device from its one-device
    input, then (the model sharded in place onto ``mesh``'s serving
    placement) the sharded layer's from the same input: the relative L2
    distance a layer, the flash launches of the sharded layers, and a
    planted fault's distance: layer 0 again with its k and v projections
    cut to the next model rank's kv heads (the wrong kv-head slice),
    which the layer gate must see."""
    from repro_torch.parallel import shard

    with torch.inference_mode():
        h = model._embed_inputs(tokens)[0]
        pos = torch.arange(h.shape[1], device=DEV)
        ins, outs = [], []
        for layer in model.layers:
            ins.append(h)
            h = model._attn_mlp_block(layer, h, pos)[0]
            outs.append(h)
        full = {k: t.detach().clone()
                for k, t in _kv_leaves(model.layers[0]).items()}
        comm = shard.shard_model(model, mesh, serving=True)
        model.comm = comm.rows_whole()
        before = ops_launches("flash_attention")
        rel = [rel_l2(model._attn_mlp_block(layer, x, pos)[0], y)
               for layer, x, y in zip(model.layers, ins, outs)]
        flash = ops_launches("flash_attention") - before
        saved = {}
        for (mod, leaf), t in _kv_leaves(model.layers[0]).items():
            n, whole = t.shape[-1], full[(mod, leaf)]
            if n == whole.shape[-1]:
                raise RuntimeError("the serving placement left the k/v "
                                   "projections whole over model")
            nxt = (comm.tp_rank + 1) % comm.tp
            saved[(mod, leaf)] = t.data
            t.data = whole.narrow(-1, nxt * n, n).contiguous()
        planted = rel_l2(model._attn_mlp_block(model.layers[0], ins[0],
                                               pos)[0], outs[0])
        for (mod, leaf), t in _kv_leaves(model.layers[0]).items():
            t.data = saved[(mod, leaf)]
        model.comm = comm
    return rel, flash, planted


def ops_launches(name: str) -> int:
    from repro_torch.kernels import ops
    return ops.LAUNCHES[name]


def _serve8_drain(rank, comm, ops, model, reqs, kw, profile=False):
    """One meshed drain on ``comm``: the streams, the engine's counters, the
    kernel launches and kernel 1's 2-D shapes, the collectives by kind, and
    (``profile``) rank 0's device time over steady ticks after it."""
    from repro_torch.runtime.server import LMServer

    comm.barrier()
    comm.stats.reset()
    ops.reset_launch_counts()
    srv = LMServer(model, cap=CAP, batch_slots=SLOTS,
                   cache_layout="paged", mesh=comm, **kw)
    ticks, remote = [], 0.0
    with GemmShapeTap(ops) as tap:
        for r in reqs:
            srv.submit(dataclasses.replace(r, tokens_out=[]))
        _dsync()
        t0 = time.perf_counter()
        while srv.scheduler.waiting or any(s is not None
                                           for s in srv.slot_req):
            t = time.perf_counter()
            srv.tick()
            _dsync()
            ticks.append(time.perf_counter() - t)
            remote = max(remote, srv.alloc.remote_fraction())
        wall = time.perf_counter() - t0
    m = srv.metrics
    out = {"streams": {r.rid: list(map(int, r.tokens_out))
                       for r in srv.scheduler.finished},
           "statuses": statuses(srv), "wall_s": wall,
           "tick_ms": [t * 1e3 for t in ticks],
           "decode_steps": m["decode_steps"], "spec_ticks": m["spec_ticks"],
           "prefill_batches": m["prefill_batches"],
           "prefill_chunks": m["prefill_chunks"],
           "prefix_hits": m["prefix_hits"],
           "launches": dict(ops.LAUNCHES),
           "shapes": sorted({f"{a}x{b}x{c}": tap.shapes.count((a, b, c))
                             for a, b, c in set(tap.shapes)}.items()),
           "whole_dim_reads": [s for s in tap.shapes
                               if 4864 in s or 151936 in s],
           "comm": comm.stats.as_dict(),
           "alloc": {"n_shards": srv.alloc.n_shards,
                     "placement": srv.alloc.placement,
                     "local_allocs": srv.alloc.local_allocs,
                     "spilled_allocs": srv.alloc.spilled_allocs,
                     "remote_fraction_max": remote},
           "local_state": {"slots": tuple(srv.state["last_tok"].shape),
                           "pool": tuple(srv.state["cache"]["kp"].shape)},
           "health": srv.health_snapshot()}
    if profile:
        steady_requests(srv, reqs, SERVE8_PROFILE_TICKS)
        if rank == 0 and DEV != "cpu":
            out["profile"] = device_profile(srv.tick, SERVE8_PROFILE_TICKS)
        else:
            for _ in range(SERVE8_PROFILE_TICKS):
                srv.tick()
        srv.run_until_drained()
    del srv
    return out


def _serve8_single(model, reqs, kw):
    from repro_torch.runtime.server import LMServer
    srv = LMServer(model, cap=CAP, batch_slots=SLOTS, cache_layout="paged",
                   **kw)
    for r in reqs:
        srv.submit(dataclasses.replace(r, tokens_out=[]))
    srv.run_until_drained()
    _dsync()
    out = {r.rid: list(map(int, r.tokens_out))
           for r in srv.scheduler.finished}
    del srv
    return out


def _slice8_serve(rank, comm, ops, out_dir):
    """Full-width qwen2-0.5b served by ONE engine over the 2x2 mesh (every
    rank runs the host side in lockstep): fp32 with ``locality`` blocks and
    again with ``round_robin`` blocks and the prefix cache (every prefix
    hit then reads pages homed on both shards); mirage with its prefill
    teacher-forced layer by layer against one device's (and a planted
    fault); mirage_rrns at 52 dB; each drain against the one-device
    engine with the same options, and the two BFP drains' steady ticks
    profiled on rank 0. The one-device references run first, one a rank,
    side by side."""
    from repro_torch.runtime.server import Request

    t0 = time.perf_counter()
    out = {}
    runs = list(SERVE8_RUNS.items())
    if rank < len(runs):
        name, (pol, kw, n_tok) = runs[rank]
        model = serve8_model(serve8_policy(pol))
        out[f"{name}_single"] = _serve8_single(
            model, serve8_requests(Request, model.cfg.vocab_size, n_tok), kw)
        del model
        _free()
    out["single_s"] = time.perf_counter() - t0
    for name, (pol, kw, n_tok) in runs:
        model = serve8_model(serve8_policy(pol))
        reqs = serve8_requests(Request, model.cfg.vocab_size, n_tok)
        if name == "mirage":
            # two of the slice's prompts, cut to the shorter: a prefill
            # batch
            L = min(len(r.prompt) for r in reqs[:2])
            probe = torch.tensor(np.stack([r.prompt[:L] for r in reqs[:2]]),
                                 device=DEV, dtype=torch.long)
            comm.barrier()
            (out["mirage_layer_rel_l2"], out["mirage_probe_flash"],
             out["mirage_planted_rel_l2"]) = \
                _teacher_forced_layers(model, probe, comm)
            out["mirage_probe_tokens"] = tuple(probe.shape)
        out[name] = _serve8_drain(rank, comm, ops, model, reqs, kw,
                                  profile=name in SERVE8_PROFILED)
        del model
        _free()
    out["seconds"] = time.perf_counter() - t0
    comm.barrier()
    return out


def phase_slice8_serve_kernels(ops, ref, policy):
    """The kernels of the meshed decode tick at a rank's shapes: kernel 1
    at M = SERVE8_M (its slots) for every layer GEMM's shard and the head's
    vocab shard, against its plain version within the f32-order bound and
    bitwise repeatable, the SERVE8_TIMED ones timed (row 1i); flash at a
    rank's heads (group 7); kernels 5 and 6 on a rank's (n_mod, G, M, N)
    blocks at 52 dB, bit for bit, timed (rows 5b and 6d)."""
    from repro_torch.analog import rrns

    t_phase = time.perf_counter()
    rows, worst = [], 0.0
    for i, (K, N) in enumerate(sorted(set(SHARD_LAYER_KN)) +
                               [SHARD_HEAD_KN]):
        gen = torch.Generator(device=DEV).manual_seed(900 + i)
        a = torch.randn((SERVE8_M, K), generator=gen, device=DEV)
        b = (torch.randn((N, K), generator=gen, device=DEV) * 0.02).T \
            if (K, N) == SHARD_HEAD_KN else \
            torch.randn((K, N), generator=gen, device=DEV) / math.sqrt(K)
        got = ops.mirage_matmul_fused(a, b, policy)
        again = ops.mirage_matmul_fused(a, b, policy)
        want = ref.mirage_gemm_ref(a, b, policy.b_m, policy.g)
        tol = gemm_bound(ref, a, b)
        err = (got - want).abs()
        bad = int((err > tol).sum())
        same = bool(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)))
        plan = card_gemm_plan(ops, SERVE8_M, K, N, policy.b_m)
        row = {"gemm": "fwd", "M": SERVE8_M, "K": K, "N": N,
               "weight_read": weight_read(b),
               "route": "mma_bf16" if plan.mma else "decode_f32",
               "splits": plan.splits, "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol).max()),
               "bitwise_repeatable": same}
        check(bad == 0 and same, f"kernel 1 outside its bound in {bad} "
                                 f"elements, or not repeatable, at the "
                                 f"meshed decode shape M={SERVE8_M} K={K} "
                                 f"N={N}")
        worst = max(worst, float(err.max()))
        if (K, N) in SERVE8_TIMED:
            aq = ref.bfp_fake_quant_ref(a, policy.b_m, policy.g)
            bq = ref.bfp_fake_quant_ref(b.T, policy.b_m, policy.g).T
            t_b, by = bound_rate(4.0 * (SERVE8_M * K + K * N + SERVE8_M * N),
                                 2.0 * SERVE8_M * N * K, F32_FLOPS_PER_S)
            row.update(
                ms=time_ms(lambda: ops.mirage_matmul_fused(a, b, policy)),
                plain_ms=time_ms(lambda: ref.mirage_gemm_ref(
                    a, b, policy.b_m, policy.g), **PLAIN_TIMING),
                library_ms=time_ms(lambda: torch.matmul(aq, bq)),
                library="torch.matmul on the pre-folded operands",
                bound_ms=t_b, bound_by=by)
            rows.append(row)
            del aq, bq
        emit({"phase": "gemm_serve_shard_vs_plain", **row})
        del a, b, got, again, want, tol, err
    for row in rows:
        emit({"phase": "timing", "kernel": "mirage_gemm", "path": "slice_8b",
              **row})
    B, L, H, Kv, D = SERVE8_FLASH
    flash_row = flash_case_row(ops, ref, "qwen2-0.5b", B, L, H, Kv, D,
                               seed=950, path="slice_8b")
    # kernels 5 and 6 on a rank's blocks of the decode tick's GEMMs
    psi = (math.prod(RNS_BASE) - 1) // 2
    tables = rrns.get_tables(RRNS_ALL, len(RNS_BASE), psi)
    n = len(RRNS_ALL)
    res_rows = {"rns_matmul_channel": [], "rrns_decode": []}
    for i, (K, N) in enumerate(SERVE8_TIMED):
        G = K // 16
        xr, wr = encoded_residue_operands(RRNS_ALL, SERVE8_M, K, N,
                                          seed=960 + i)
        gen = torch.Generator(device=DEV).manual_seed(970 + i)
        noise = detector_noise(RRNS_ALL, (G, SERVE8_M, N), SNR_DB, gen)
        got, flips = ops.rns_group_matmul_channel(
            xr, wr, RRNS_ALL, noise, None, count_flips=True)
        want, want_flips = ref.rns_matmul_channel_ref(
            xr, wr, RRNS_ALL, noise, None, count_flips=True)
        bad5 = int((got != want).sum()) + int(
            flips.tolist() != want_flips.tolist())
        dec, votes = ops.rrns_decode(got, tables)
        want_dec, want_votes = ref.rrns_decode_ref(got, tables)
        bad6 = int((dec != want_dec).sum()) + int(
            (votes.view(torch.int32) != want_votes.view(torch.int32)).sum())
        check(bad5 == 0 and bad6 == 0,
              f"kernel 5 or 6 differs from its plain version on a rank's "
              f"block M={SERVE8_M} K={K} N={N}: {bad5}, {bad6}")
        S = n * G
        shape = {"M": SERVE8_M, "K": K, "N": N, "n_mod": n, "G": G,
                 "path": "slice_8b", "mismatches": bad5}
        t_b, by = bound_rate(
            4.0 * (S * SERVE8_M * 16 + S * 16 * N + 2 * S * SERVE8_M * N),
            2.0 * S * SERVE8_M * N * 16, INT_OPS_PER_S)
        xf = xr.reshape(S, SERVE8_M, 16).float()
        wf = wr.reshape(S, 16, N).float()
        res_rows["rns_matmul_channel"].append({
            **shape,
            "ms": time_ms(lambda: ops.rns_group_matmul_channel(
                xr, wr, RRNS_ALL, noise, None)),
            "plain_ms": time_ms(lambda: ref.rns_matmul_channel_ref(
                xr, wr, RRNS_ALL, noise, None), **PLAIN_TIMING),
            "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
            "library": "torch.bmm (no mod, no readout)",
            "bound_ms": t_b, "bound_by": by})
        res_rows["rrns_decode"].append(decode_timing_row(
            ops, ref, got, tables, {**shape, "mismatches": bad6,
                                    "inputs": "path"}))
        del xr, wr, noise, got, want, dec, votes, xf, wf
    for name, rs in res_rows.items():
        for row in rs:
            emit({"phase": "timing", "kernel": name, **row})
    emit({"phase": "slice8_serve_kernels",
          "phase_seconds": time.perf_counter() - t_phase})
    free_card()
    return {"mirage_gemm": rows, "flash": flash_row, **res_rows}, worst


def serve8_line(ranks):
    """The ``slice_8_serve`` line from the ranks' results, and its checks
    (run by the caller after every slice-8 line is out)."""
    sv = [r["serve"] for r in ranks]
    s0 = sv[0]
    checks = []

    def gate(ok, what):
        checks.append((bool(ok), what))
    n_layers = 24 if not REDUCED else len(s0["mirage_layer_rel_l2"])
    per_step = 7 * n_layers + 1
    summary = {}
    for key, (_, _, n_tok) in SERVE8_RUNS.items():
        runs = [s[key] for s in sv]
        r0 = runs[0]
        steps = r0["decode_steps"] + r0["prefill_batches"] + \
            r0["prefill_chunks"]
        summary[key] = {
            "statuses": r0["statuses"], "ticks": len(r0["tick_ms"]),
            "decode_steps": r0["decode_steps"],
            "prefill_batches": r0["prefill_batches"],
            "prefill_chunks": r0["prefill_chunks"],
            "prefix_hits": r0["prefix_hits"],
            "wall_s_by_rank": [r["wall_s"] for r in runs],
            "tick_ms_median_by_rank": [float(np.median(r["tick_ms"]))
                                       for r in runs],
            "launches_by_rank": [{k: v for k, v in r["launches"].items()
                                  if v} for r in runs],
            "model_steps": steps,
            "comm_rank0": r0["comm"],
            "page_exchange_bytes_per_tick": r0["comm"]["page_exchange"]
            ["bytes"] / max(len(r0["tick_ms"]), 1),
            "alloc": r0["alloc"], "local_state": r0["local_state"],
            "health": r0["health"]}
        gate(all(r["streams"] == r0["streams"] for r in runs),
             f"{key}: the ranks' hosts read different streams")
        summary[key]["max_tokens"] = n_tok
        gate(len(r0["streams"]) == N_REQUESTS and all(
            len(t) == n_tok for t in r0["streams"].values()),
            f"{key}: not every request drained with its tokens")
        gate(not any(r["whole_dim_reads"] for r in runs),
             f"{key}: kernel 1 read a whole sharded dim (N = 4,864 or "
             f"151,936)")
        if key != "fp32_locality" and key != "fp32_round_robin_prefix":
            for r, run in enumerate(runs):
                gate(run["launches"]["mirage_gemm" if key == "mirage" else
                                     "rns_matmul_channel"] ==
                     per_step * steps,
                     f"{key}: rank {r} launched "
                     f"{run['launches']} for {steps} model steps, not "
                     f"{per_step} a step")
    def single_of(name):
        return next(s[f"{name}_single"] for s in sv
                    if f"{name}_single" in s)
    for name in SERVE8_RUNS:
        single = single_of(name)
        same = [rid for rid, t in single.items()
                if s0[name]["streams"].get(rid) == t]
        summary[name]["equal_to_one_device"] = len(same)
        gate(len(same) == N_REQUESTS,
             f"{name}: the meshed streams equal the one-device engine's in "
             f"{len(same)} of {N_REQUESTS} requests")
    loc = summary["fp32_locality"]["alloc"]
    gate(loc["n_shards"] == 2 and loc["local_allocs"] > 0 and
         loc["spilled_allocs"] == 0 and loc["remote_fraction_max"] == 0.0,
         f"locality placement: {loc}")
    gate(summary["fp32_locality"]["comm_rank0"]["page_exchange"]["bytes"]
         == 0, "pages moved under locality placement")
    rr = summary["fp32_round_robin_prefix"]
    gate(rr["prefix_hits"] > 0 and
         rr["comm_rank0"]["page_exchange"]["bytes"] > 0 and
         rr["alloc"]["remote_fraction_max"] > 0,
         f"round_robin + prefix moved no page or hit no prefix: {rr}")
    # the first tokens of the locality drain's streams
    summary["fp32_round_robin_prefix"]["equal_to_locality_streams"] = all(
        t == s0["fp32_locality"]["streams"][rid][:len(t)]
        for rid, t in s0["fp32_round_robin_prefix"]["streams"].items())
    mirage = s0["mirage"]
    same = sum(a == b for rid, t in single_of("mirage").items()
               for a, b in zip(t, mirage["streams"][rid]))
    summary["mirage"]["token_share_vs_one_device"] = \
        same / sum(len(t) for t in mirage["streams"].values())
    rel = [max(s["mirage_layer_rel_l2"][i] for s in sv)
           for i in range(n_layers)]
    gate(max(rel) <= SERVE8_LAYER_TOL,
         f"mirage prefill, teacher-forced: layer {int(np.argmax(rel))} at "
         f"{max(rel)} relative L2 of one device's (limit "
         f"{SERVE8_LAYER_TOL})")
    planted = [s["mirage_planted_rel_l2"] for s in sv]
    gate(min(planted) > SERVE8_LAYER_TOL,
         f"the layer gate missed a planted fault (layer 0 on the wrong kv "
         f"heads): {planted} relative L2, limit {SERVE8_LAYER_TOL}")
    for r, s in enumerate(sv):
        gate(s["mirage_probe_flash"] == n_layers,
             f"rank {r}: the sharded prefill launched flash "
             f"{s['mirage_probe_flash']} times, not once a layer")
        run = s["mirage"]
        gate(run["launches"]["flash_attention"] ==
             n_layers * run["prefill_batches"],
             f"rank {r}: flash {run['launches']['flash_attention']} times "
             f"for {run['prefill_batches']} prefill batches")
    decode_shapes = {f"{SERVE8_M}x{k}x{n}" for k, n in SHARD_LAYER_KN} | \
        {f"{SERVE8_M}x{SHARD_HEAD_KN[0]}x{SHARD_HEAD_KN[1]}"}
    seen = {k for k, _ in mirage["shapes"] if k.startswith(f"{SERVE8_M}x")}
    if not REDUCED:
        gate(seen == decode_shapes, f"the meshed decode tick ran kernel 1 "
                                    f"at {sorted(seen)}, not the shard "
                                    f"shapes {sorted(decode_shapes)}")
    rrns = s0["rrns_52db"]
    gate(rrns["health"].get("rrns_uncorrected", 0) == 0,
         f"mirage_rrns 52 dB on the mesh: {rrns['health']}")
    for r, s in enumerate(sv):
        run = s["rrns_52db"]
        gate(run["launches"]["rrns_decode"] ==
             run["launches"]["rns_matmul_channel"],
             f"rank {r}: rrns_decode {run['launches']['rrns_decode']} vs "
             f"rns_matmul_channel {run['launches']['rns_matmul_channel']}")
    profiles = {name: {k: (s0[name].get("profile") or {}).get(k) for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "device_kernels",
        "rng_device_ms", "rng_host_ms", "top_device_ms")}
        for name in SERVE8_PROFILED}
    line = {"phase": "slice_8_serve", "arch": "qwen2-0.5b",
            "mesh": {"data": SLICE8_MESH[0], "model": SLICE8_MESH[1]},
            "backend": ranks[0]["backend"], "device": ranks[0]["device"],
            "ranks_on_one_card": len(ranks), "slots": SLOTS,
            "requests": N_REQUESTS,
            "prompt_lens": list(PROMPT_LENS), "shared_prefix": SERVE8_PREFIX,
            "cap": CAP, "expected_gemm_per_model_step": per_step,
            "mirage_layer_rel_l2": rel, "mirage_layer_tol": SERVE8_LAYER_TOL,
            "mirage_planted_rel_l2_by_rank": planted,
            "mirage_probe_tokens": s0["mirage_probe_tokens"],
            "decode_tick_profile_rank0": profiles,
            "mirage_gemm_shapes_rank0": mirage["shapes"],
            "runs": summary,
            "collective_note": "ranks on one card over gloo: host-clock "
                               "seconds of the code path (staging through "
                               "pinned host memory, loopback TCP), not "
                               "NVLink",
            "single_s_by_rank": [s["single_s"] for s in sv],
            "seconds": s0["seconds"]}
    emit(line)
    return checks, {f"serve_2x2_{k}_rank0": v["launches_by_rank"][0]
                    for k, v in summary.items()}


def slice8_rank(rank: int, world: int, out_dir: str, reduced: bool,
                device: str) -> None:
    """One rank of the slice-8 phases (a process of its own): the gloo
    group from a file store, the 2x2 mesh on ``device``, then slice 8a's
    three phases and slice 8b's ``serve``; what it found goes to
    ``out_dir/rank<r>.pt``."""
    global REDUCED, DEV
    REDUCED, DEV = reduced, device
    import torch.distributed as dist
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.parallel.comm import MeshComm

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = pathlib.Path(out_dir)
    dev = torch.device(device if device != "cuda" else "cuda:0")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} finds no CUDA device")
        build.extension()
    init_distributed(dev, SLICE8_BACKEND, rank=rank, world_size=world,
                     store=dist.FileStore(str(out_dir / "store"), world))
    comm = MeshComm(make_debug_mesh(*SLICE8_MESH, device=dev,
                                    backend=SLICE8_BACKEND), dev)
    res = {"rank": rank, "backend": comm.backend, "coord": comm.coord,
           "device": str(dev)}
    for name, fn in (("train", _slice8_train), ("moe_ep", _slice8_moe_ep),
                     ("elastic", _slice8_elastic), ("serve", _slice8_serve)):
        t0 = time.perf_counter()
        res[name] = fn(rank, comm, ops, out_dir)
        res[name]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({"slice8_rank0": name,
                              "seconds": res[name]["seconds"]}), flush=True)
    torch.save(res, out_dir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def start_launcher_nccl(out_dir: pathlib.Path):
    """``python -m repro_torch.launch.train --distributed`` as ONE torchrun
    rank on cuda:0 under NCCL (the card's only NCCL path: two ranks on one
    card are refused), 1 step at ELASTIC_LAYERS layers, in the
    background."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = pathlib.Path(__file__).resolve().parent / "src"
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=str(src))
    argv = [sys.executable, "-m", "repro_torch.launch.train",
            "--distributed", "--steps", "1", "--layers",
            str(ELASTIC_LAYERS)] + (["--reduced", "--device", "cpu"]
                                    if REDUCED else [])
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(out_dir))


def start_launcher_shared_card():
    """The same launcher as a second torchrun rank whose LOCAL_RANK (1)
    names a card this host does not have: NCCL would put two ranks on one
    card, and the launcher refuses before it joins a group."""
    src = pathlib.Path(__file__).resolve().parent / "src"
    env = dict(os.environ, RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1",
               PYTHONPATH=str(src))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--distributed",
         "--steps", "1"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _by_layer(by_leaf, agg):
    """Per-leaf values folded per layer (``layers.N``) with ``agg``; the
    leaves outside the layers by name."""
    out = {}
    for k, v in by_leaf.items():
        parts = k.split(".")
        key = ".".join(parts[:2]) if parts[0] == "layers" else k
        out[key] = agg(out.get(key, v), v)
    return out


def phase_slice8(ops):
    """The three slice-8 phases in one spawn of 4 ranks (the NCCL launcher
    run beside their start-up), each phase's line from the ranks' files;
    returns the launches of kernel 1 a rank made on the 2x2 train path."""
    import shutil
    import torch.multiprocessing as mp

    out_dir = pathlib.Path(__file__).resolve().parent / "build" / "slice8"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = SLICE8_MESH[0] * SLICE8_MESH[1]
    _free()
    t0 = time.perf_counter()
    launcher = start_launcher_nccl(out_dir)
    refused = start_launcher_shared_card()
    try:
        mp.spawn(slice8_rank, args=(world, str(out_dir), REDUCED, DEV),
                 nprocs=world)
    finally:
        try:
            stdout, stderr = launcher.communicate(timeout=300)
            _, refused_err = refused.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            launcher.kill()
            refused.kill()
            raise
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    shutil.rmtree(out_dir / "ckpt", ignore_errors=True)

    # --- slice_8_train ---
    tr = [r["train"] for r in ranks]
    per_step = 3 * (7 * tr[0]["layers"] + 1)
    cfg_kn = SHARD_LAYER_KN * tr[0]["layers"] + (SHARD_HEAD_KN,)
    if REDUCED:
        cfg_kn = None
    shapes_ok, full_reads = True, []
    for t in tr:
        for shapes in t["shapes"]:
            fwd = [(k, n) for _, k, n in shapes[:len(shapes) // 3]]
            if cfg_kn is not None and tuple(fwd) != cfg_kn:
                shapes_ok = False
            full_reads += [s for s in shapes if 4864 in s or 151936 in s]
    single = tr[0]["single_losses"]
    mirage_rel = [abs(a - b) / abs(b) for a, b in
                  zip(tr[0]["losses"], single)]
    # the planted fault: the loss rank 0 would report with the other data
    # rank left out of the mean is a data rank's own mean
    fault_rel = {t["dp_rank"]: abs(t["local_loss"] - single[0]) /
                 abs(single[0]) for t in tr}
    mg = dict(tr[0]["mirage_grads"])
    by_layer = {"sound_max": _by_layer(mg.pop("by_leaf"), max),
                "fault_min": _by_layer(mg.pop("fault_by_leaf"), min)}
    fp32 = tr[0]["fp32"]
    line = {"phase": "slice_8_train", "arch": "qwen2-0.5b", "mesh":
            {"data": SLICE8_MESH[0], "model": SLICE8_MESH[1]},
            "backend": ranks[0]["backend"], "device": ranks[0]["device"],
            "ranks_on_one_card": world, "policy": "mirage", "steps":
            SLICE8_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "params_per_rank": [t["params"] for t in tr],
            "params_full": tr[0]["full_params"],
            "step_ms": [[s * 1e3 for s in t["step_s"]] for t in tr],
            "peak_mem_gb": [t["peak_gb"] for t in tr],
            "mirage_gemm_per_step": [[n["mirage_gemm"] for n in t["launches"]]
                                     for t in tr],
            "expected_per_step": per_step,
            "gemm_shapes_rank0_step1": sorted(
                {f"{m}x{k}x{n}": tr[0]["shapes"][0].count((m, k, n))
                 for m, k, n in set(tr[0]["shapes"][0])}.items()),
            "forward_reads_shards": shapes_ok,
            "launches_reading_a_whole_sharded_dim": len(full_reads),
            "collectives_per_step_rank0": tr[0]["comm"],
            "collective_note": "ranks on one card over gloo: host-clock "
                               "seconds of the code path (staging through "
                               "pinned host memory, loopback TCP), not "
                               "NVLink",
            "losses": tr[0]["losses"], "single_device_losses":
            tr[0]["single_losses"], "mirage_loss_rel": mirage_rel,
            "mirage_loss_rel_tol": SLICE8_MIRAGE_LOSS_TOL,
            "mirage_loss_rel_one_data_rank_left_out": fault_rel,
            "mirage_step1_grads": mg,
            "mirage_step1_grad_rel_l2_by_layer": by_layer,
            "mirage_grad_rel_l2_tol": {"every_leaf": SLICE8_MIRAGE_GRAD_TOL,
                                       SLICE8_MIRAGE_HEAD_LEAF:
                                       SLICE8_MIRAGE_HEAD_TOL},
            "fp32": fp32,
            "seconds": tr[0]["seconds"]}
    emit(line)
    checks = []

    def check(ok, what):      # noqa: F811 (every phase's line first)
        checks.append((bool(ok), what))
    for r, t in enumerate(tr):
        check(all(n["mirage_gemm"] == per_step for n in t["launches"]),
              f"rank {r} launched kernel 1 {[n['mirage_gemm'] for n in t['launches']]} "
              f"times a step, not {per_step} (the single-device step's)")
    check(shapes_ok, "a forward GEMM of the 2x2 step read other than its "
                     "shard (N/2 or K/2)")
    check(not full_reads, f"{len(full_reads)} GEMMs read a whole sharded "
                          f"dim: {full_reads[:4]}")
    check(all(math.isfinite(v) for v in tr[0]["losses"]),
          f"a sharded loss is not finite: {tr[0]['losses']}")
    check(fp32["loss_rel"] <= 1e-5, f"fp32 2x2 loss {fp32['loss']} vs one "
                                    f"device {fp32['single_loss']}")
    check(fp32["grad_rel_l2_max"] <= 1e-5,
          f"fp32 2x2 gradient {fp32['grad_rel_l2_worst_leaf']} at "
          f"{fp32['grad_rel_l2_max']} relative L2")
    check(fp32["param_max_abs_where_grad_ge_1e-6"] <= 5e-5,
          f"fp32 2x2 params off by "
          f"{fp32['param_max_abs_where_grad_ge_1e-6']} where |g| >= "
          f"{SLICE8_ADAM_G}")
    check(mirage_rel[0] <= SLICE8_MIRAGE_LOSS_TOL,
          f"mirage 2x2 step-1 loss off one device's by {mirage_rel[0]}")
    check(min(fault_rel.values()) > SLICE8_MIRAGE_LOSS_TOL,
          f"the mirage loss gate ({SLICE8_MIRAGE_LOSS_TOL}) cannot see a "
          f"data rank left out of the mean: {fault_rel}")
    check(mg["grad_rel_l2_max"] <= SLICE8_MIRAGE_GRAD_TOL,
          f"mirage 2x2 step-1 gradient {mg['grad_rel_l2_worst_leaf']} at "
          f"{mg['grad_rel_l2_max']} relative L2 of one device's")
    head = SLICE8_MIRAGE_HEAD_LEAF
    check(by_layer["sound_max"][head] <= SLICE8_MIRAGE_HEAD_TOL,
          f"mirage 2x2 step-1 gradient {head} at "
          f"{by_layer['sound_max'][head]} relative L2 of one device's")
    check(min(by_layer["fault_min"].values()) > SLICE8_MIRAGE_GRAD_TOL and
          by_layer["fault_min"][head] > SLICE8_MIRAGE_HEAD_TOL,
          f"the mirage gradient gates cannot see a data rank left out of "
          f"the mean: {by_layer['fault_min']}")

    # --- slice_8_moe_ep ---
    me = [r["moe_ep"] for r in ranks]
    emit({"phase": "slice_8_moe_ep", "arch": "qwen3-moe-30b-a3b",
          "layers": 1, "moe_impl": "ep_shard_map", "backend":
          ranks[0]["backend"], "experts": me[0]["experts"],
          "experts_per_rank": me[0]["experts_local"],
          "tokens_per_data_rank": me[0]["tokens_local"],
          "ranks": {r: {k: v for k, v in m.items() if k.startswith("factor")}
                    for r, m in enumerate(me)},
          "seconds": me[0]["seconds"]})
    for r, m in enumerate(me):
        for f in ("factor_8.0", "factor_1.25"):
            res = m[f]
            check(res["grads_finite"] and all(
                v > 0 for v in res["grad_norms"].values()),
                f"rank {r} EP gradients at {f}: {res['grad_norms']}")
            # 3 forward stack GEMMs and their 6 backward ones
            check(res["launches"]["mirage_gemm"] == 9,
                  f"rank {r} EP launched kernel 1 {res['launches']} times, "
                  f"not 9")
            if "y_rel_max" in res:
                check(res["y_rel_max"] <= 1e-5,
                      f"rank {r} EP output at {f} off {res['reference']} "
                      f"by {res['y_rel_max']} (relative to its max)")
                check(res["aux_vs_global"] <= 1e-5,
                      f"rank {r} EP aux at {f} off the global means' by "
                      f"{res['aux_vs_global']}")
        check(m["factor_8.0"].get("dropped_local", 0) == 0,
              "the dropless EP case dropped tokens")
    check(any(m["factor_1.25"].get("dropped_local", 0) > 0 for m in me),
          "capacity 1.25 dropped no token: the per-shard case is not "
          "exercised")

    # --- slice_8_elastic ---
    el = [r["elastic"] for r in ranks]
    emit({"phase": "slice_8_elastic", "arch": "qwen2-0.5b",
          "layers": ELASTIC_LAYERS, "reduced": {"n_layers": f"{ELASTIC_LAYERS} "
                                                "of 24 (time limit)"},
          "saved_on": "2x2", "restored_on": ["1x4", "1x1"],
          "diff_1x4": max(e["diff_1x4"] for e in el),
          "diff_1x1": el[0]["diff_1x1"], "q_shard_1x4": el[0]["q_shard_1x4"],
          "o_shard_1x4": el[0]["o_shard_1x4"],
          "save_s": el[0]["save_s"], "restore_1x4_s": el[0]["restore_1x4_s"],
          "seconds": el[0]["seconds"]})
    check(all(e["diff_1x4"] == 0.0 and e["step_1x4"] == 1 for e in el),
          "the 2x2 state restored onto 1x4 is not bit for bit")
    check(el[0]["diff_1x1"] == 0.0 and el[0]["step_1x1"] == 1,
          "the 2x2 state restored onto one device is not bit for bit")

    # --- the launcher under NCCL (1 rank) ---
    ok = launcher.returncode == 0 and "final loss" in stdout
    emit({"phase": "slice_8_launcher_nccl", "ranks": 1, "backend": "nccl"
          if not REDUCED else "gloo", "returncode": launcher.returncode,
          "stdout_tail": stdout[-300:], "stderr_tail": stderr[-600:]
          if not ok else "", "spawn_and_phases_s": spawn_s})
    check(ok, f"launch.train --distributed (1 rank, NCCL) failed: "
              f"{stderr[-2000:]}")
    refused_ok = refused.returncode != 0 and \
        "two ranks would share" in refused_err
    emit({"phase": "slice_8_launcher_shared_card", "local_rank": 1,
          "cards": torch.cuda.device_count() if DEV != "cpu" else 0,
          "returncode": refused.returncode,
          "error": refused_err.strip().splitlines()[-1:]})
    check(refused_ok or REDUCED, "a second rank on the one card was not "
                                 "refused with a clear error")

    # --- slice_8_serve (slice 8b) ---
    serve_checks, serve_launches = serve8_line(ranks)
    checks += serve_checks
    for ok, what in checks:
        globals()["check"](ok, what)
    return {"train_2x2_rank_per_step": [
        [n["mirage_gemm"] for n in t["launches"]] for t in tr],
        "moe_ep_rank0": {f: me[0][f]["launches"]["mirage_gemm"]
                         for f in ("factor_8.0", "factor_1.25")},
        **serve_launches}



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA "
              "card", file=sys.stderr)
        return 2
    src = pathlib.Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import build, ops, ref
    from repro_torch.runtime.server import Request

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    ptxas = start_flash_ptxas()
    build.extension()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "build_dir": str(build.BUILD_DIR)})
    flash_regs = phase_flash_ptxas(ptxas)

    if sys.argv[1:] == ["--audit-rrns-health"]:
        return audit_rrns_health(ops)
    policy = get_policy("mirage")
    err_bfp = phase_bfp(ops, ref)
    err_gemm = phase_gemm(ops, ref, policy)
    phase_gemm_options(ops, ref)
    err_gemm = max(err_gemm, phase_gemm_bwd(ops, ref, policy))
    err_bwd_stacks, bwd_stack_rows = phase_gemm_bwd_batched(ops, ref, policy)
    err_gemm = max(err_gemm, err_bwd_stacks)
    err_batched, batched_rows = phase_gemm_batched(ops, ref, policy)
    err_gemm = max(err_gemm, err_batched)
    err_flash = phase_flash(ops, ref)
    gemm6d_rows, flash6d_rows, err6d_gemm, err6d_flash = \
        phase_slice6d_kernels(ops, ref, policy)
    err_gemm = max(err_gemm, err6d_gemm)
    gemm6e_rows, err6e_gemm = phase_slice_mamba2_kernels(ops, ref, policy)
    err_gemm = max(err_gemm, err6e_gemm)
    gemm6f_rows, flash6f_rows, err6f_gemm, err6f_flash = \
        phase_slice_zamba2_kernels(ops, ref, policy, flash_regs)
    err_gemm = max(err_gemm, err6f_gemm)
    err_flash = max(err_flash, err6f_flash)
    gemm6g_rows, flash6g_rows, err6g_gemm, err6g_flash = \
        phase_slice_seamless_kernels(ops, ref, policy)
    err_gemm = max(err_gemm, err6g_gemm)
    err_flash = max(err_flash, err6g_flash)
    err_flash = max(err_flash, err6d_flash)
    err_rns = phase_rns_matmul(ops, ref)
    err_channel = phase_rns_channel(ops, ref)
    err_decode = phase_rrns_decode(ops, ref)
    phase_rns_equals_fast(ops, ref)
    chaos_rows = phase_chaos_kernels(ops, ref)
    launches, batches, steps, model, cap, streams = phase_slice(ops)
    paged_launches = phase_slice_paged(ops, model, cap, streams)
    rrns_launches, _, rrns_streams, rrns_cold = phase_slice_rrns(
        ops, model, cap)
    rrns_paged_launches = phase_slice_rrns_paged(ops, model, cap,
                                                 rrns_streams)
    rns_launches = phase_slice_rns(ops, model, cap)
    options_launches = phase_serve_paged_options(ops, cap)
    warm_launches = phase_serve_warmup(ops, model, cap,
                                       {"rrns_52db": rrns_cold,
                                        **COLD_DRAINS})
    pipe_launches = phase_serve_pipelined(ops, model, cap, streams)
    phase_serve_resize(ops, model, cap)
    phase_serve_switch(ops, model, cap, streams)
    phase_slice_rrns_vs_cpu(model, cap, make_requests(
        Request, model.cfg.vocab_size)[0].prompt)
    guardian_launches = phase_chaos_guardian(ops, model)
    channel_launches = phase_chaos_channel(ops, model)
    host_launches = phase_chaos_host(ops, model)
    phase_deadlines_and_snapshot(ops, model)
    del model
    free_card()
    moe_launches = {arch: phase_slice_moe(ops, arch, n, paged)
                    for arch, n, paged in MOE_SLICES}
    train_launches = phase_slice_train(ops)
    phase_train_fp32_vs_cpu(n_layers=TRAIN_FP32_LAYERS)
    phase_train_grads_vs_cpu(ops, ref)
    wsq_launches = phase_slice_train_wsq(ops, ref)
    free_card()
    slice8_rows, err8 = phase_slice8_kernels(ops, ref, policy)
    err_gemm = max(err_gemm, err8)
    serve8_rows, err8b = phase_slice8_serve_kernels(ops, ref, policy)
    err_gemm = max(err_gemm, err8b)
    slice8_launches = phase_slice8(ops)
    free_card()
    moe_train_launches = {arch: phase_slice_train_moe(ops, arch, n, steps)
                          for arch, n, steps in MOE_TRAIN_SLICES}
    moe_wsq_launches = {arch: phase_slice_train_wsq(
        ops, ref, (0,), arch, 1, f"slice_train_wsq_moe_{MOE_ARCH_OF[arch]}",
        card_copies=True)
        for arch in MOE_WSQ_ARCHS}
    phase_train_moe_grads_vs_cpu(ops, ref)
    # one step: the CPU's step over 1.25 B f32 parameters is the phase's
    # cost (the dense phase keeps 2)
    phase_train_fp32_vs_cpu("qwen3-moe-30b-a3b", MOE_FP32_LAYERS,
                            "train_moe_fp32_vs_cpu", n_steps=1)
    free_card()
    moe_rns_rows = phase_rns_stacks(ops, ref)
    moe_rns_launches = {MOE_ARCH_OF[arch]: phase_slice_moe_rns(ops, arch, n)
                        for arch, n in MOE_RNS_SLICES}
    moe_stationary_launches = {
        MOE_ARCH_OF[arch]: phase_slice_moe_rrns_stationary(ops, arch, n)
        for arch, n in MOE_STATIONARY_SLICES}
    moe_rns_train_launches = phase_slice_train_moe_rns(ops)
    vlm_launches = phase_slice_internvl2(ops)
    vlm_train_launches = phase_slice_train_internvl2(ops)
    cr_launches = phase_slice_command_r(ops)
    mamba_launches = phase_slice_mamba2(ops)
    mamba_eng_launches = phase_ssm_engines(
        ops, MAMBA_ARCH, MAMBA_ENGINE_LAYERS, "slice_mamba2_engines")
    mamba_rrns_launches = phase_slice_mamba2_rrns(ops)
    mamba_train_launches = phase_slice_train_mamba2(ops)
    zamba_launches = phase_slice_zamba2(ops)
    zamba_eng_launches = phase_ssm_engines(
        ops, ZAMBA_ARCH, ZAMBA_ENGINE_LAYERS, "slice_zamba2_engines")
    zamba_rrns_launches = phase_slice_zamba2_rrns(ops)
    zamba_train_launches = phase_slice_train_zamba2(ops)
    seamless_launches = phase_slice_seamless(ops)
    seamless_rrns_launches = phase_slice_seamless_rrns(ops)
    seamless_train_launches = phase_slice_train_seamless(ops)
    reduced_launches = phase_serve_reduced(ops)
    phase_train_resume()
    rns_train_launches, rns_per_step = phase_slice_train_rns(ops, ref,
                                                             layers=(0,))
    twins = phase_twins(ops)
    rows = phase_timing(ops, ref, policy, GEMM_PER_STEP)
    rows.update(phase_timing_rns(ops, ref, GEMM_PER_STEP))
    phase_timing_train(ops, ref, policy)
    phase_timing_train_rns(ops, ref)
    emit({"phase": "timer", "spin_cycles": SPIN_CYCLES,
          "calls_whose_enqueue_outlasted_the_spin": len(TIMER_OVERRUNS),
          "examples": TIMER_OVERRUNS[:10]})

    def entry(kernel, source, replaces, err, main_row, path=None):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        path = launches if path is None else path
        return {"name": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": path[kernel],
                "max_abs_err": err, **{k: main_row[k] for k in keys},
                "ok": True, "shape": {k: v for k, v in main_row.items()
                                      if k not in keys}}

    def head_row(kernel):
        """A GEMM kernel's headline shape: the tied head at decode, its
        largest launch."""
        return max((r for r in rows[kernel] if r["M"] == SLOTS and
                    r.get("inputs", "path") == "path"),
                   key=lambda r: r["N"])

    head = head_row("mirage_gemm")
    gemm = entry("mirage_gemm", "mirage_gemm.cu",
                 "src/repro/kernels/mirage_gemm.py:50", err_gemm, head)
    # the same kernel batched over experts (one launch per expert stack);
    # at decode its stream route (mirage_gemm_stack.cu), whose pre-pass
    # counts under gemm_stream_prep
    gemm["batched"] = {k: batched_rows[0][k] for k in (
        "model", "gemm", "E", "M", "K", "N", "route", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "library", "decode_route_ms",
        "routed_ms", "routed_bound_ms", "routed_live_experts")}
    gemm["launches_moe"] = {arch: runs["dense_cold"]["mirage_gemm"]
                            for arch, runs in moe_launches.items()}
    stream_rows = [r for r in batched_rows if r["route"] == "stream_f32"]
    gemm["stream"] = {
        "name": "mirage_gemm (stream route)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mirage_gemm_stack.cu",
        "replaces": "src/repro/kernels/mirage_gemm.py:50 under the vmap "
                    "of src/repro/models/moe.py:50-66",
        "launches": {arch: runs["dense_cold"]["gemm_stream_prep"]
                     for arch, runs in moe_launches.items()},
        "helper": "gemm_stream_prep (one a stream-route stack)",
        "max_abs_err": err_batched,
        **{k: stream_rows[0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "rows": [{k: r[k] for k in (
            "model", "gemm", "E", "M", "K", "N", "splits", "ms",
            "decode_route_ms", "plain_ms", "library_ms", "bound_ms",
            "routed_live_experts", "routed_ms", "routed_bound_ms")}
            for r in stream_rows]}
    # the expert stacks' backward GEMMs (MoE training): dX and dW, one
    # launch a stack, on the tensor-core route
    bwd_head = bwd_stack_rows[0]
    gemm["backward_stacks"] = {
        "name": "mirage_gemm (expert stacks' dX and dW)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mirage_gemm.cu",
        "replaces": "src/repro/kernels/mirage_gemm.py:50 under the vmap "
                    "of src/repro/core/gemm.py:169-189 (_mm_bwd)",
        "launches": {arch: n["mirage_gemm"]
                     for arch, n in moe_train_launches.items()},
        "max_abs_err": err_bwd_stacks,
        **{k: bwd_head[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "rows": bwd_stack_rows}
    flash = entry("flash_attention", "flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:81", err_flash,
                  rows["flash_attention"][0])
    flash["head_dims"] = [
        {k: r[k] for k in ("B", "L", "H", "Kv", "D", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "library")}
        | {"ptxas": flash_regs.get(r["D"])}
        for r in rows["flash_attention"] if r["window"] is None and
        r["L"] == 128 and r["B"] == 4]
    flash["launches_serve_reduced"] = reduced_launches["flash_attention"]
    # slice 6d: the new shapes of kernels 1 and 3, and their launches on
    # the internvl2 and command-r paths
    gemm["slice_6d"] = {
        "rows": gemm6d_rows,
        "launches": {"internvl2_dense_cold": vlm_launches["cold"]
                     ["mirage_gemm"],
                     "internvl2_patch_prefill": vlm_launches[
                         "patch_prefill"]["mirage_gemm"],
                     "train_internvl2": vlm_train_launches["mirage_gemm"],
                     "command_r_dense_cold": cr_launches["cold"]
                     ["mirage_gemm"]}}
    # slice 6e: kernel 1 at mamba2-2.7b's shapes, and its launches on the
    # SSM family's paths
    gemm["slice_6e"] = {
        "rows": gemm6e_rows,
        "launches": {"mamba2_dense_cold": mamba_launches["cold"]
                     ["mirage_gemm"],
                     "mamba2_dense_warmed": mamba_launches["warmed"]
                     ["mirage_gemm"],
                     **{f"mamba2_8_layers_{k}": v.get("mirage_gemm", 0)
                        for k, v in mamba_eng_launches.items()},
                     "train_mamba2": mamba_train_launches["mirage_gemm"]}}
    # slice 6f: kernel 1 at zamba2-2.7b's shapes (row 1f) and flash at the
    # shared block's D = 80 (row 3c), and their launches on the hybrid's
    # paths
    gemm["slice_6f"] = {
        "rows": gemm6f_rows,
        "launches": {"zamba2_dense_cold": zamba_launches["cold"]
                     ["mirage_gemm"],
                     "zamba2_dense_warmed": zamba_launches["warmed"]
                     ["mirage_gemm"],
                     **{f"zamba2_6_layers_{k}": v.get("mirage_gemm", 0)
                        for k, v in zamba_eng_launches.items()},
                     "train_zamba2": zamba_train_launches["mirage_gemm"]}}
    flash["slice_6f"] = {
        "rows": flash6f_rows, "ptxas_d80": flash_regs.get(80),
        "launches": {"zamba2_dense_cold": zamba_launches["cold"]
                     ["flash_attention"],
                     "zamba2_dense_warmed": zamba_launches["warmed"]
                     ["flash_attention"],
                     **{f"zamba2_6_layers_{k}": v.get("flash_attention", 0)
                        for k, v in zamba_eng_launches.items()}}}
    # slice 6g: kernel 1 at seamless-m4t-large-v2's shapes (row 1g) and
    # flash non-causal at its encoder's L = 1,024 (row 3d), and their
    # launches on the enc-dec paths
    gemm["slice_6g"] = {
        "rows": gemm6g_rows,
        "launches": {"seamless_served": seamless_launches["mirage_gemm"],
                     "train_seamless": seamless_train_launches["mirage_gemm"]}}
    flash["slice_6g"] = {
        "rows": flash6g_rows,
        "launches": {"seamless_served": seamless_launches["flash_attention"],
                     **{f"seamless_4_layers_{k}": v["flash_attention"]
                        for k, v in seamless_rrns_launches.items()}}}
    # slice 8a: kernel 1 at qwen2-0.5b's TP = 2 shard shapes (row 1h), and
    # its launches a rank on the 2x2 training step and the EP MoE path
    gemm["slice_8"] = {"rows": slice8_rows, "launches": slice8_launches}
    # slice 8b: kernel 1 at the meshed decode tick's shard shapes (row 1i),
    # flash at a rank's heads, kernels 5 and 6 on a rank's blocks, and their
    # launches a rank on the 2x2 engine's drains
    gemm["slice_8b"] = {"rows": serve8_rows["mirage_gemm"], "launches": {
        k: v.get("mirage_gemm", 0) for k, v in slice8_launches.items()
        if k.startswith("serve_2x2")}}
    flash["slice_8b"] = {"rows": [serve8_rows["flash"]], "launches": {
        k: v.get("flash_attention", 0) for k, v in slice8_launches.items()
        if k.startswith("serve_2x2")}}
    flash["slice_6d"] = {
        "rows": flash6d_rows,
        "launches": {"internvl2_dense_cold": vlm_launches["cold"]
                     ["flash_attention"],
                     "command_r_dense_cold": cr_launches["cold"]
                     ["flash_attention"]}}
    rns = entry("rns_matmul", "rns_matmul.cu",
                "src/repro/kernels/rns_matmul.py:52", err_rns,
                head_row("rns_matmul"), rns_launches)
    rns["training_launches"] = rns_train_launches["rns_matmul"]
    rns["training_launches_per_step"] = rns_per_step
    channel = entry("rns_matmul_channel", "rns_matmul.cu",
                    "src/repro/kernels/rns_matmul.py:131", err_channel,
                    head_row("rns_matmul_channel"), rrns_launches)
    decode = entry("rrns_decode", "rrns_decode.cu",
                   "src/repro/kernels/rrns_decode.py:140", err_decode,
                   head_row("rrns_decode"), rrns_launches)
    # the MoE paths under the paper's datapath (slice 6c): each kernel's
    # launches there, and its rows at the expert stacks' blocks
    for kernel, k_entry, paths in (
            ("rns_matmul", rns, ("rrns_clean", "rns")),
            ("rns_matmul_channel", channel, ("rrns_52db",)),
            ("rrns_decode", decode, ("rrns_52db", "rrns_clean"))):
        k_entry["launches_moe"] = {
            f"{arch}_{path}": runs[path][kernel]
            for arch, runs in moe_rns_launches.items() for path in paths}
        if kernel != "rns_matmul":
            k_entry["launches_moe"].update({
                f"{arch}_rrns_52db_stationary": n[kernel]
                for arch, n in moe_stationary_launches.items()})
        else:
            k_entry["launches_moe"]["train_qwen3-moe_rns"] = \
                moe_rns_train_launches["rns_matmul"]
        k_entry["moe_stacks"] = moe_rns_rows[kernel]
        k_entry["launches_mamba2_16_layers"] = {
            path: n[kernel] for path, n in mamba_rrns_launches.items()
            if kernel in n}
        k_entry["launches_zamba2_12_layers"] = {
            path: n[kernel] for path, n in zamba_rrns_launches.items()
            if kernel in n}
        k_entry["launches_seamless_4_layers"] = {
            path: n[kernel] for path, n in seamless_rrns_launches.items()
            if n.get(kernel)}
        # slice 7: the chaos drains (kernel 5 none under an open scope)
        k_entry["launches_chaos"] = {
            **{f"guardian_{k}": n[kernel]
               for k, n in guardian_launches.items()},
            **{f"channel_faults_{k}": n[kernel]
               for k, n in channel_launches.items()},
            "host_faults": host_launches[kernel]}
    # rows 4c and 6c: kernels 4 and 6 at n_mod 7 (the guardian's r = 4)
    rns["n_mod_7"] = chaos_rows["rns_matmul"]
    decode["n_mod_7"] = chaos_rows["rrns_decode"]
    for kernel, k_entry in (("rns_matmul_channel", channel),
                            ("rrns_decode", decode)):
        k_entry["slice_8b"] = {
            "rows": serve8_rows[kernel],
            "launches": slice8_launches["serve_2x2_rrns_52db_rank0"]
            .get(kernel, 0)}
    flash["launches_chaos"] = {f"guardian_{k}": n["flash_attention"]
                               for k, n in guardian_launches.items()}
    emit({"kernels": [
        gemm,
        flash,
        entry("bfp_quantize", "bfp_quantize.cu",
              "src/repro/kernels/bfp_quantize.py:55", err_bfp,
              max(rows["bfp_quantize"], key=lambda r: r["rows"]),
              wsq_launches),
        rns,
        channel,
        decode,
    ], "main_path": {"prefill_batches": batches, "decode_steps": steps,
                     "train_steps": TRAIN_STEPS, "wsq_steps": WSQ_STEPS,
                     "launches_by_path": {
                         "mirage_fast": launches,
                         "mirage_fast_paged": paged_launches,
                         "mirage_rrns_52db": rrns_launches,
                         "mirage_rrns_paged": rrns_paged_launches,
                         "mirage_paged_options": options_launches,
                         "mirage_fast_warmed": warm_launches["dense"],
                         "mirage_fast_paged_warmed": warm_launches["paged"],
                         "mirage_spec_warmed": warm_launches["paged_spec"],
                         "mirage_rrns_52db_warmed":
                             warm_launches["rrns_52db"],
                         "mirage_fast_pipelined": pipe_launches,
                         **{f"{arch}_{name}": n
                            for arch, runs in moe_launches.items()
                            for name, n in runs.items()},
                         "mirage_rns": rns_launches,
                         "train_mirage": train_launches,
                         "train_mirage_2x2_per_rank_step":
                             slice8_launches["train_2x2_rank_per_step"],
                         "moe_ep_2x2_rank0": slice8_launches["moe_ep_rank0"],
                         **{k: v for k, v in slice8_launches.items()
                            if k.startswith("serve_2x2")},
                         "train_wsq_bfp": wsq_launches,
                         **{f"train_moe_{arch}": n
                            for arch, n in moe_train_launches.items()},
                         **{f"train_wsq_bfp_moe_{arch}": n
                            for arch, n in moe_wsq_launches.items()},
                         **{f"{arch}_{path}": n
                            for arch, runs in moe_rns_launches.items()
                            for path, n in runs.items()},
                         **{f"{arch}_rrns_52db_stationary": n
                            for arch, n in moe_stationary_launches.items()},
                         "train_moe_qwen3-moe_rns": moe_rns_train_launches,
                         **{f"internvl2_{k}": v
                            for k, v in vlm_launches.items()},
                         "train_internvl2": vlm_train_launches,
                         **{f"command_r_{k}": v
                            for k, v in cr_launches.items()},
                         **{f"mamba2_{k}": v
                            for k, v in mamba_launches.items()},
                         **{f"mamba2_8_layers_{k}": v
                            for k, v in mamba_eng_launches.items()},
                         **{f"mamba2_16_layers_{k}": v
                            for k, v in mamba_rrns_launches.items()},
                         "train_mamba2": mamba_train_launches,
                         **{f"zamba2_{k}": v
                            for k, v in zamba_launches.items()},
                         **{f"zamba2_6_layers_{k}": v
                            for k, v in zamba_eng_launches.items()},
                         **{f"zamba2_12_layers_{k}": v
                            for k, v in zamba_rrns_launches.items()},
                         "train_zamba2": zamba_train_launches,
                         **{f"chaos_guardian_{k}": n
                            for k, n in guardian_launches.items()},
                         **{f"chaos_channel_{k}": n
                            for k, n in channel_launches.items()},
                         "chaos_host": host_launches,
                         "seamless_served": seamless_launches,
                         **{f"seamless_4_layers_{k}": v
                            for k, v in seamless_rrns_launches.items()},
                         "train_seamless": seamless_train_launches,
                         "serve_reduced": reduced_launches,
                         "train_mirage_rns": rns_train_launches,
                         "twins": {k: v["launches"]
                                   for k, v in twins.items()}},
                     "note": "each kernel's launches come from the path "
                             "that runs it: mirage_gemm and flash_attention "
                             "from serving under mirage_fast (training "
                             "launches mirage_gemm 3 x 169 times a step, "
                             "train_mirage), rns_matmul_channel and "
                             "rrns_decode from mirage_rrns at 52 dB, "
                             "rns_matmul from mirage_rns, bfp_quantize "
                             "standalone from weight-stationary training "
                             "with BFP gradient compression (train_wsq_bfp; "
                             "elsewhere it runs inside mirage_gemm as its "
                             "prologue, bfp.cuh); flash at head_dim 16 from "
                             "serve --reduced and rns_matmul in full-width "
                             "mirage_rns training are listed beside; the "
                             "paged engine's paths (slice 5) beside them: "
                             "mirage_fast_paged and mirage_rrns_paged "
                             "repeat the dense drains through block "
                             "tables, mirage_paged_options sums the five "
                             "mirage engines of serve_paged_options; the "
                             "*_warmed paths replay the tick as a CUDA "
                             "graph (serve_warmup: each equals its cold "
                             "drain's launches), mirage_fast_pipelined "
                             "prefills on the worker's stream "
                             "(serve_pipelined); the MoE paths (slice_moe, "
                             "slice_moe_mixtral) launch mirage_gemm batched "
                             "over the experts, 7 x layers + 1 a model "
                             "step (launches_moe: their cold dense "
                             "drains), each stack of C <= 16 rows on the "
                             "stream route with one gemm_stream_prep "
                             "launch beside it (stream.launches); the MoE "
                             "training paths (train_moe_*: slice_train_moe "
                             "and slice_train_moe_mixtral) launch it 3 x "
                             "(7 x layers + 1) a step, each expert stack's "
                             "forward, dX and dW one launch "
                             "(backward_stacks); train_wsq_bfp_moe_* adds "
                             "bfp_quantize, one launch a weight (an expert "
                             "stack one) and a gradient leaf each step; "
                             "the MoE paths under the paper's datapath "
                             "(slice_moe_rrns, slice_moe_rns, "
                             "slice_moe_rrns_stationary, "
                             "slice_train_moe_rns: launches_moe) launch "
                             "rns_matmul_channel (52 dB) or rns_matmul "
                             "(clean, mirage_rns) and rrns_decode once a "
                             "residue block, each expert stack over (n_mod, "
                             "E x G) slots in blocks of whole experts "
                             "(moe_stacks); slice 6d (slice_internvl2, "
                             "slice_train_internvl2, slice_command_r: "
                             "internvl2_*, train_internvl2, command_r_*) "
                             "launch mirage_gemm 7 x layers + 1 a model "
                             "step (2 more where a prefill carries "
                             "patches, 3 x (7 x layers + 1) + 5 a "
                             "training step) and flash_attention once a "
                             "layer a prefill batch; slice 6e (slice_mamba2 "
                             "at 16 layers, slice_mamba2_engines at 8, "
                             "slice_mamba2_rrns at 16, slice_train_mamba2 "
                             "at 16: mamba2_*, train_mamba2) launch "
                             "mirage_gemm 2 x layers + 1 a model step (a "
                             "verify tick 2 x (k + 1) x layers + 1, a "
                             "training step 3 x (2 x layers + 1)), "
                             "rns_matmul_channel or rns_matmul and "
                             "rrns_decode once a residue block, and no "
                             "flash_attention; slice 6f (slice_zamba2 at "
                             "54 layers, slice_zamba2_engines at 6, "
                             "slice_zamba2_rrns at 12, slice_train_zamba2 "
                             "at 54: zamba2_*, train_zamba2) launch "
                             "mirage_gemm 2 x layers + 8 x applications + "
                             "1 a model step (181 at 54 layers; a verify "
                             "tick 2 x (k + 1) x layers + 8 x applications "
                             "+ 1, a training step 3 x 181), "
                             "flash_attention once an application a "
                             "prefill batch (D = 80, MHA), and the "
                             "residue kernels once a residue block; slice "
                             "6g (slice_seamless at 24 + 24 layers, "
                             "slice_seamless_rrns at 4 + 4, "
                             "slice_train_seamless at 24 + 24: seamless_*, "
                             "train_seamless) serves through the model's "
                             "own prefill and greedy decode_step (no engine "
                             "serves enc-dec in either package) and "
                             "launches mirage_gemm 1 + 6 x encoder layers + "
                             "10 x decoder layers + 1 a prefill (386), 8 x "
                             "decoder layers + 1 a decode step (193), 3 x "
                             "386 - 1 a training step (the frames take no "
                             "dX), flash_attention once an encoder layer "
                             "(non-causal) and once a decoder "
                             "self-attention (causal) a prefill (48; the "
                             "cross-attention stays plain, as in JAX), and "
                             "the residue kernels once a residue block; "
                             "slice 7 (chaos_guardian, chaos_channel, "
                             "chaos_host at full width, 4 requests of 16 "
                             "prompt tokens, 8 tokens each: chaos_*, "
                             "launches_chaos) runs every GEMM under an open "
                             "fault scope through rns_matmul and the plain "
                             "readout, then rrns_decode, once a residue "
                             "block each (rns_matmul_channel never), at "
                             "n_mod 5 and, on the guardian's r = 4 rung, 7 "
                             "(rows n_mod_7), and flash once a layer a "
                             "prefill batch on every rung"}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
