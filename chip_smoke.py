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
training held to the CPU end to end and step 1's gradients leaf by leaf
(with a TF32 control the limits must catch), mirage training
teacher-forced GEMM by GEMM; weight-stationary training with BFP gradient
compression (the BFP quantizer kernel on its path; its GEMMs
teacher-forced too); and the backward GEMMs timed.

Closing slice 2: the flash kernel at head dims 16, 24 (padded to the 32
instance), 80 and 128 (and each instance's registers and spills from
``nvcc -Xptxas -v``, built beside the extension), ``python -m
repro_torch.launch.serve --reduced`` through the flash kernel at head_dim
16 (under fp32, greedy streams equal to the CPU's), full-width mirage
training through ``launch.train`` stopped by SIGTERM at step 2 and
resumed with ``--resume``, bit for bit equal to 4 straight steps (then the
checkpoint's bytes and its save and restore times), 3 full-width
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
cache, with speculative decoding, with all three): under fp32 each
engine's streams equal the dense engine's (or differ first where the
dense logits' top-2 gap is under 1e-4), under mirage the GEMM launches
equal 169 x the engine's own count of model steps.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Optional

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
                       "splitk_reduce_kernel", "flash_fwd_kernel",
                       "rns_matmul_kernel", "rrns_decode_kernel",
                       "bfp_fake_quant_kernel", "bfp_fake_quant_vec_kernel")


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
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

    server = LMServer(model, cap=cap, batch_slots=SLOTS)
    reqs = make_requests(Request, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    for r in reqs:
        server.submit(r)
    finished = server.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)

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


def device_profile(run, n: int):
    """Device time by kernel over ``n`` calls of ``run`` (torch.profiler),
    per call, and the device's idle share of their wall time. Only the
    device's own events count: a host op's self device time is the time of
    the kernels it launched, which appear as events of their own, so
    summing both would count every kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, launches = {}, 0
    for avg in prof.key_averages():
        dev_us = getattr(avg, "self_device_time_total", 0.0)
        if avg.device_type == DeviceType.CUDA and dev_us > 0:
            by_kernel[avg.key] = by_kernel.get(avg.key, 0.0) + dev_us
            launches += avg.count
    busy_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    ours = {k[:80]: v / 1e3 / n for k, v in by_kernel.items()
            if any(name in k for name in PORT_KERNEL_SYMBOLS)}
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy_ms / n,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top_device_ms": {k[:80]: v / 1e3 / n for k, v in top},
            "port_kernels_ms": ours, "device_kernels": launches / n}


def profile_ticks(model, cap, reqs, LMServer, policy_name: str,
                  n_ticks: int = 3, **engine_kw):
    """Device time by kernel over a few steady decode ticks (torch.profiler)
    and the device's idle share of their wall time."""
    server = LMServer(model, cap=cap, batch_slots=SLOTS, **engine_kw)
    for r in reqs[:SLOTS]:
        r = dataclasses.replace(r, tokens_out=[])
        server.submit(r)
    server.tick()                      # admission + first decode
    prof = device_profile(server.tick, n_ticks)
    emit({"phase": "decode_tick_profile", "policy": policy_name,
          "ticks": n_ticks,
          "wall_ms_per_tick": prof["wall_ms"],
          "device_busy_ms_per_tick": prof["device_busy_ms"],
          "device_idle_share": prof["device_idle_share"],
          "device_kernels_per_tick": prof["device_kernels"],
          "top_device_ms_per_tick": prof["top_device_ms"],
          "port_kernels_ms_per_tick": prof["port_kernels_ms"]})


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


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
        for layer_d, layer_h in zip(model.layers, cpu_model.layers):
            out_d, _ = model._attn_mlp_block(layer_d, h, pos_d)
            out_h, _ = cpu_model._attn_mlp_block(layer_h, h.cpu(), pos_h)
            layer_err.append(rel_l2(out_d.cpu(), out_h))
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


def serve_run(ops, model, cap, reqs, LMServer, **engine_kw):
    """Program a fresh engine (with ``engine_kw``), reset the counts, drain
    ``reqs``; return the engine, the finished requests, the seconds and the
    launches."""
    t0 = time.perf_counter()
    server = LMServer(model, cap=cap, batch_slots=SLOTS, **engine_kw)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    for r in reqs:
        server.submit(r)
    finished = server.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_run
    return server, finished, dt, dict(ops.LAUNCHES), program_s


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
    model.policy = noisy
    profile_ticks(model, cap, reqs, LMServer, "mirage_rrns 52 dB")
    return launches, c_launches, streams


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

        def audited(xr, wr, moduli, cfg, draws):
            drawn, normal = {}, draws.normal

            def keep(stage, shape):
                drawn[stage] = normal(stage, shape)
                return drawn[stage]
            draws.normal = keep
            try:
                out = inner(xr, wr, moduli, cfg, draws)
            finally:
                draws.normal = normal
            if "detector" in drawn:
                self.add(xr, wr, moduli, cfg, drawn["detector"], out)
            return out

        self.module._readout_on_card = audited
        return self

    def add(self, xr, wr, moduli, cfg, unit_noise, out):
        clean = self.ops.rns_group_matmul(xr, wr, moduli)
        self.ops.LAUNCHES["rns_matmul"] -= 1       # not the path's launch
        shape = (-1, 1, 1, 1)
        noise = unit_noise * torch.tensor(cfg.detector_sigmas(moduli),
                                          device=DEV).reshape(shape)
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
    a = server.alloc
    a.check_invariants()
    cache = server.state["cache"]
    return {"block_size": a.block_size, "n_blocks": a.n_blocks,
            "peak_in_use": a.peak_in_use, "in_use_after_drain": a.used_count,
            "pool_gb": sum(cache[k].numel() * cache[k].element_size()
                           for k in ("kp", "vp")) / 1e9}


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
    """Host wall time of one steady decode tick of ``SLOTS`` requests (the
    mean of ``n_ticks``, after the admission tick), to a synchronize."""
    from repro_torch.runtime.server import LMServer

    server = LMServer(model, cap=cap, batch_slots=SLOTS, **engine_kw)
    for r in reqs[:SLOTS]:
        server.submit(dataclasses.replace(r, tokens_out=[]))
    server.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        server.tick()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_ticks


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


def phase_serve_paged_options(ops, model, cap):
    """8 requests sharing a 64-token prefix through the dense engine and
    four paged ones (chunked prefill, prefix cache, speculative decoding,
    all three). fp32: the streams equal the dense engine's, or first
    differ where the dense logits' top-2 gap is under TOP2_GAP. mirage:
    speed, the share of tokens equal to dense, the prefix and speculative
    counters, and GEMM launches = 169 x the engine's model steps."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.server import LMServer, Request

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
            firsts = []
            for rid, toks in dense.items():
                j = next((i for i, (a, b) in enumerate(zip(streams[rid],
                                                           toks))
                          if a != b), None)
                if j is not None:
                    firsts.append({"rid": rid, "position": j,
                                   "dense_top2_gap": dense_top2_gap(
                                       model, prompts[rid], toks[:j])})
            row["first_differences"] = firsts
            check(all(f["dense_top2_gap"] < TOP2_GAP for f in firsts),
                  f"serve_paged_options fp32 {name}: a stream differs from "
                  f"the dense engine's where the top-2 gap is >= "
                  f"{TOP2_GAP}: {firsts}")
        out[policy] = {name: row for name, (_, _, row) in runs.items()}
    emit({"phase": "serve_paged_options", "slots": SLOTS, "cap": cap,
          "block_size": PAGED_BS, "prefill_chunk": PREFILL_CHUNK,
          "spec_k": SPEC_K, "shared_prefix": SHARED_PREFIX,
          "tail_lens": list(TAIL_LENS), **out})
    return total


def phase_slice_rrns_vs_cpu(model, cap, prompt_np, layers=(0, 11, 23)):
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
            out_d, _ = model._attn_mlp_block(layer_d, h, pos_d)
            if li in layers:
                out_h, _ = cpu_model._attn_mlp_block(cpu_model.layers[li],
                                                     h.cpu(), pos_h)
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


def train_setup(policy, **tc_kw):
    """The launcher's model (weights from seed 0), train config and data."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    cfg = get_config("qwen2-0.5b")
    cfg = cfg.reduced() if REDUCED else cfg
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
    product is exact in f32, only the order of the f32 sum differs."""
    aq = ref.bfp_fake_quant_ref(a, 4, 16)
    bq = ref.bfp_fake_quant_ref(b.T, 4, 16).T if quantize_w else b
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
    prof = device_profile(lambda: step(state, next(data)), 2)
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
    """Step 1's loss and gradients (by parameter name, on the CPU) of
    ``model`` on a numpy ``batch``."""
    params = dict(model.named_parameters())
    loss, _ = model.loss({k: torch.from_numpy(v).to(model.device)
                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.cpu() for k, g in zip(params, grads)}


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
    """The global norm of a tree of gradients, summed in f64."""
    return math.sqrt(sum(float(t.double().square().sum())
                         for t in tree.values()))


def grads_vs(got_loss, got, want_loss, want):
    """Loss, global grad norm and per-leaf errors of one set of step-1
    gradients against another."""
    errs = leaf_errors(got, want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:8]
    return {"loss_rel": abs(got_loss - want_loss) / abs(want_loss),
            "grad_norm_rel": abs(norm64(got) - norm64(want)) / norm64(want),
            "leaf_rel_max": worst[0][1], "worst_leaves": dict(worst),
            "by_kind": leaf_kinds(errs)}


def phase_train_fp32_vs_cpu():
    """2 fp32 steps at full width on the card and on the CPU from the same
    weights and batches (TF32 off): loss and grad norm within 1e-4. Step
    1's gradients are also held leaf by leaf (each within 1e-4 of its
    leaf's largest element), and once more with TF32 on as a control: a
    lower precision these limits must catch. The CPU's global norm is
    compared with the f64 sum, beside an f32 ``torch._foreach_norm``."""
    from repro_torch.core.backends import baselines
    from repro_torch.core.precision import get_policy
    from repro_torch.optim.optimizers import global_norm

    cfg, model, tc, data = train_setup(get_policy("fp32"))
    cpu_model = copy.deepcopy(model).to("cpu")
    batches = [data.batch_at(i) for i in range(2)]
    cpu_loss, cpu_grads = step1_grads(cpu_model, batches[0])
    leaves = grads_vs(*step1_grads(model, batches[0]), cpu_loss, cpu_grads)
    pin = baselines._pin_full_f32   # the fp32 backend pins TF32 off
    baselines._pin_full_f32 = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = grads_vs(*step1_grads(model, batches[0]), cpu_loss,
                        cpu_grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        baselines._pin_full_f32 = pin
    exact = norm64(cpu_grads)
    serial = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(cpu_grads.values()))))
    cpu_norm = {"global_norm_rel_to_f64":
                abs(float(global_norm(cpu_grads)) - exact) / exact,
                "f32_foreach_norm_rel_to_f64": abs(float(serial) - exact) /
                exact}
    del cpu_grads
    t0 = time.perf_counter()
    _, _, _, card = run_train(model, tc, iter(batches), 2)
    card_s = time.perf_counter() - t0
    del model
    t0 = time.perf_counter()
    _, _, _, plain = run_train(cpu_model, tc, iter(batches), 2)
    cpu_s = time.perf_counter() - t0
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(card, plain)]
           for k in ("loss", "grad_norm")}
    ok = max(max(v) for v in rel.values()) < 1e-4
    leaves_ok = leaves["leaf_rel_max"] < 1e-4
    tf32["caught_by_the_1e-4_limits"] = max(
        tf32["loss_rel"], tf32["grad_norm_rel"], tf32["leaf_rel_max"]) >= 1e-4
    emit({"phase": "train_fp32_vs_cpu", "steps": 2,
          "card": card, "cpu": plain, "rel_err": rel,
          "step1_grads_tf32_off": leaves, "step1_grads_tf32_on": tf32,
          "cpu_step1_grad_norm": cpu_norm, "card_seconds": card_s,
          "cpu_seconds": cpu_s, "ok": ok and leaves_ok})
    check(ok, f"fp32 training on the card differs from the CPU by >= 1e-4 "
              f"relative: {rel}")
    check(leaves_ok, f"an fp32 step-1 gradient leaf on the card differs from "
                     f"the CPU's by >= 1e-4 of its largest element: "
                     f"{leaves['worst_leaves']}")


class GemmCapture:
    """Records (x, w, dO) and the policy of the model GEMMs at the listed
    call indices by wrapping ``repro_torch.core.gemm.mirage_matmul`` (the
    differentiable op ``mirage_matmul_auto`` takes under grad); w keeps
    its layout."""

    def __init__(self, keep):
        from repro_torch.core import gemm
        self.gemm, self.keep, self.calls, self.got = gemm, set(keep), 0, {}

    def __enter__(self):
        self.inner = inner = self.gemm.mirage_matmul

        def recorded(x, w, policy):
            i = self.calls
            self.calls += 1
            out = inner(x, w, policy)
            if i in self.keep:
                rec = self.got[i] = {"x": x.detach().clone(),
                                     "w": w.detach(), "policy": policy}
                out.register_hook(
                    lambda g, rec=rec: rec.__setitem__("dO",
                                                       g.detach().clone()))
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


def cpu_capture(cpu_model, batch, layers, wsq_policy=None):
    """The CPU's step-1 forward and backward with the GEMMs of ``layers``
    and the head recorded; under ``wsq_policy`` on the weight-stationary
    copies, as the trainer runs it. Returns (loss, capture, head index)."""
    from repro_torch.runtime.trainer import _Loss, _prequantize_params

    n_layers = len(cpu_model.layers)
    head = len(LAYER_GEMMS) * n_layers
    keep = [len(LAYER_GEMMS) * li + j for li in layers
            for j in range(len(LAYER_GEMMS))] + [head]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    run = dict(cpu_model.named_parameters())
    with GemmCapture(keep) as cap:
        if wsq_policy is None:
            loss, _ = cpu_model.loss(batch)
        else:
            run = _prequantize_params(run, wsq_policy, torch.float32)
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
        want = function_grads(rec["x"], rec["w"], rec["dO"], policy)
        x, w, d = to_card(rec["x"]), to_card(rec["w"]), to_card(rec["dO"])
        got = function_grads(x, w, d, policy)
        d2 = d.reshape(-1, d.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        as_is = policy.assume_quantized_weights
        bounds = (gemm_bound(ref, d2, w.T, not as_is).reshape(x.shape),
                  gemm_bound(ref, x2.T, d2))
        errs = []
        for g, wv, tol in zip(got, want, bounds):
            e = (g - to_card(wv)).abs()
            errs.append((float(e.max()), float((e / tol).max())))
            if bool((e > tol).any()):
                bad.append(name)
        rows[name] = {"weight_as_is": as_is,
                      "dX_weight_read": weight_read(w.T),
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


def phase_slice_train_wsq(ops, ref, layers=(0, 11, 23)):
    """3 steps with weight-stationary quantization and BFP gradient
    compression: kernel #2 quantizes the 168 GEMM weights and every
    non-scalar gradient leaf each step. Step 1's loss against the CPU's,
    and its GEMMs teacher-forced as in ``train_grads_vs_cpu``: the CPU's
    (x, w, dO) of layers 0, 11 and 23 and the head, w the trainer's
    transposed view of a contiguous (N, K) copy, so dX runs the kernel on
    that contiguous copy as it is."""
    from repro_torch.core.precision import get_policy
    from repro_torch.runtime.trainer import _quantized_names

    policy = get_policy("mirage", assume_quantized_weights=True)
    cfg, model, tc, data = train_setup(policy, weight_stationary_quant=True,
                                       grad_compression="bfp")
    cpu_model = copy.deepcopy(model).to("cpu")
    batches = [data.batch_at(i) for i in range(WSQ_STEPS)]
    params = dict(model.named_parameters())
    n_quant = len(_quantized_names(params))
    n_leaves = sum(1 for p in params.values() if p.dim() > 0)
    per_step = 7 * cfg.n_layers + 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _, _, times, logs = run_train(model, tc, iter(batches), WSQ_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    del model
    want = {"mirage_gemm": 3 * per_step * WSQ_STEPS,
            "bfp_quantize": (n_quant + n_leaves) * WSQ_STEPS}
    t0 = time.perf_counter()
    cpu_loss, cap, head = cpu_capture(cpu_model, batches[0], layers, policy)
    cpu_s = time.perf_counter() - t0
    rows, bad = teacher_forced(ref, cap, head)
    # dX = dO @ W^T must read the contiguous (N, K) copy as a row-major
    # (K' = N, N' = K) operand, the kernel's quantize-skipping (K, N) route
    wrong_layout = [n for n, r in rows.items() if n != "head" and
                    r["dX_weight_read"] != "(K, N) row-major"]
    losses = [m["loss"] for m in logs]
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    emit({"phase": "slice_train_wsq", "steps": WSQ_STEPS,
          "quantized_weights": n_quant, "gradient_leaves": n_leaves,
          "launches": launches, "expected_launches": want,
          "step_ms": [t * 1e3 for t in times], "losses": losses,
          "cpu_step1_loss": cpu_loss, "step1_loss_rel_err": rel,
          "gemms": rows, "cpu_seconds": cpu_s,
          "ok": rel < 1e-3 and not bad and not wrong_layout})
    check(all(math.isfinite(v) for v in losses),
          f"a weight-stationary training loss is not finite: {losses}")
    expect_launches(launches, want, "slice_train_wsq")
    check(rel < 1e-3, f"wsq step-1 loss card {losses[0]} vs CPU "
                      f"{cpu_loss}: {rel:.2e} relative")
    check(not wrong_layout, f"a weight-stationary dX did not read the "
                            f"contiguous (N, K) copy: {wrong_layout}")
    check(not bad, f"wsq card dX/dW outside the GEMM bound of the CPU's at "
                   f"{bad}")
    return launches


# --------------------------------------------------------------------------
# phases 13-16: closing slice 2 — serve --reduced through flash at D = 16,
# checkpoint and resume at full width, mirage_rns training at full width,
# and the example twins
# --------------------------------------------------------------------------

#: scratch for the checkpoints of train_resume and the twins, removed after
CKPT_ROOT = pathlib.Path(__file__).resolve().parent / "build" / \
    "chip_smoke_ckpt"
RESUME_STEPS, RNS_TRAIN_STEPS = 4, 3
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
    """Full width under mirage through ``launch.train.main``: 4 steps
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
    common = entry_argv(["--ckpt-every", str(RESUME_STEPS)], reduced=True)
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
    """3 full-width mirage_rns steps: every forward, dX and dW GEMM through
    kernel 4, launched over group blocks wherever one launch's residues
    would pass the budget (the tied head). Losses finite, peak memory
    below 24 GB, launches as the plan says; step 1's GEMMs of layers 0 and
    23 and the head, teacher-forced (the card's own x, w and dO of step 1),
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
    prof = device_profile(lambda: step(state, next(data)), 1)
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
          "step_ms_median_2_to_3": step_s * 1e3,
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
                a, b, policy.b_m, policy.g, quantize_w=qw)),
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
                    x, w, policy.b_m, policy.g)),
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
                q, k, v, True, window)),
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
                x, policy.b_m, policy.g)),
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
                x, policy.b_m, policy.g)),
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


def sdpa_yardstick(ref, q, k, v, window, allowed):
    """PyTorch's scaled_dot_product_attention on the same f32 inputs, as
    (B, heads, L, D) copies with enable_gqa: is_causal where there is no
    window (no mask tensor), the boolean mask otherwise. The fastest backend
    that accepts the call is the yardstick. Beside it, not the yardstick:
    each backend on K/V repeated to every query head beforehand (another
    call, reading rep x the K/V bytes)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = {"is_causal": True} if window is None else {"attn_mask": allowed}
    by_backend, outs = sdpa_backends(
        lambda: sdpa(qt, kt, vt, enable_gqa=True, **kw))
    ms, name = min((t, n) for n, t in by_backend.items() if t is not None)
    want = ref.flash_attention_ref(q, k, v, True, window)
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
                                n=5),
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
                    xr, wr, RRNS_ALL), n=5),
                "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
                "bound_ms": t_b, "bound_by": by})
            t_b, by = bound_rate(b4 + 4.0 * S * M * N, o4, INT_OPS_PER_S)
            rows["rns_matmul_channel"].append({
                **shape,
                "ms": time_ms(lambda: ops.rns_group_matmul_channel(
                    xr, wr, RRNS_ALL, noise)),
                "plain_ms": time_ms(lambda: ref.rns_matmul_channel_ref(
                    xr, wr, RRNS_ALL, noise), n=5),
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
                                n=5),
            "library_ms": time_ms(lambda: torch.bmm(xf, wf)),
            "bound_ms": t_b, "bound_by": by})
        del xr, wr, xf, wf
    for row in rows:
        emit({"phase": "timing", "kernel": "rns_matmul", "path": "train",
              **row})
    return rows


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
    err_flash = phase_flash(ops, ref)
    err_rns = phase_rns_matmul(ops, ref)
    err_channel = phase_rns_channel(ops, ref)
    err_decode = phase_rrns_decode(ops, ref)
    phase_rns_equals_fast(ops, ref)
    launches, batches, steps, model, cap, streams = phase_slice(ops)
    paged_launches = phase_slice_paged(ops, model, cap, streams)
    rrns_launches, _, rrns_streams = phase_slice_rrns(ops, model, cap)
    rrns_paged_launches = phase_slice_rrns_paged(ops, model, cap,
                                                 rrns_streams)
    rns_launches = phase_slice_rns(ops, model, cap)
    options_launches = phase_serve_paged_options(ops, model, cap)
    phase_slice_rrns_vs_cpu(model, cap, make_requests(
        Request, model.cfg.vocab_size)[0].prompt)
    del model
    torch.cuda.empty_cache()
    train_launches = phase_slice_train(ops)
    phase_train_fp32_vs_cpu()
    phase_train_grads_vs_cpu(ops, ref)
    wsq_launches = phase_slice_train_wsq(ops, ref)
    torch.cuda.empty_cache()
    reduced_launches = phase_serve_reduced(ops)
    phase_train_resume()
    rns_train_launches, rns_per_step = phase_slice_train_rns(ops, ref)
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
    rns = entry("rns_matmul", "rns_matmul.cu",
                "src/repro/kernels/rns_matmul.py:52", err_rns,
                head_row("rns_matmul"), rns_launches)
    rns["training_launches"] = rns_train_launches["rns_matmul"]
    rns["training_launches_per_step"] = rns_per_step
    emit({"kernels": [
        entry("mirage_gemm", "mirage_gemm.cu",
              "src/repro/kernels/mirage_gemm.py:50", err_gemm, head),
        flash,
        entry("bfp_quantize", "bfp_quantize.cu",
              "src/repro/kernels/bfp_quantize.py:55", err_bfp,
              max(rows["bfp_quantize"], key=lambda r: r["rows"]),
              wsq_launches),
        rns,
        entry("rns_matmul_channel", "rns_matmul.cu",
              "src/repro/kernels/rns_matmul.py:131", err_channel,
              head_row("rns_matmul_channel"), rrns_launches),
        entry("rrns_decode", "rrns_decode.cu",
              "src/repro/kernels/rrns_decode.py:140", err_decode,
              head_row("rrns_decode"), rrns_launches),
    ], "main_path": {"prefill_batches": batches, "decode_steps": steps,
                     "train_steps": TRAIN_STEPS, "wsq_steps": WSQ_STEPS,
                     "launches_by_path": {
                         "mirage_fast": launches,
                         "mirage_fast_paged": paged_launches,
                         "mirage_rrns_52db": rrns_launches,
                         "mirage_rrns_paged": rrns_paged_launches,
                         "mirage_paged_options": options_launches,
                         "mirage_rns": rns_launches,
                         "train_mirage": train_launches,
                         "train_wsq_bfp": wsq_launches,
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
                             "mirage engines of serve_paged_options"}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
