"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card, serves full-width
qwen2-0.5b (random weights from a seed) through the port's ``LMServer``,
checks that the serving path launched exactly the expected kernels, and times
every kernel at the shapes the serving path gives it. Each phase prints one
JSON line; any failed check exits non-zero. The last line is the device
record. Without CUDA, or without the repository's ``src`` beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores

SLOTS, N_REQUESTS, MAX_TOKENS = 4, 8, 32
PROMPT_LENS = (17, 128)       # inclusive range of the numpy-seeded lengths
GEMM_KN = ((896, 896), (896, 128), (896, 4864), (4864, 896), (896, 151936))
GEMM_M = (4, 8, 256)
# launches of each GEMM shape per decode tick (= per prefill batch): q and o
# are 896->896, k and v 896->128, gate and up 896->4864, down 4864->896, per
# layer x 24, plus the tied head 896->151936 once
GEMM_PER_STEP = {(896, 896): 48, (896, 128): 48, (896, 4864): 48,
                 (4864, 896): 24, (896, 151936): 1}
# (B, L, H, Kv, D, window): the prefill attention shapes
FLASH_CASES = ((4, 128, 14, 2, 64, None), (4, 512, 14, 2, 64, None),
               (4, 77, 14, 2, 64, None), (4, 128, 14, 2, 64, 32))


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


def time_ms(fn, n: int = 20, warmup: int = 3, flush_l2: bool = True) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events), with
    the 50 MB L2 cache flushed before each launch, as the serving path finds
    a layer's weights cold."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if flush_l2:
            scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


def phase_bfp(ops, ref, policy):
    worst = 0
    for shape, seed in (((4096, 4864), 1), ((8, 896), 2)):
        x = bfp_inputs(*shape, seed)
        got = ops.bfp_fake_quant(x, policy)
        want = ref.bfp_fake_quant_ref(x, policy.b_m, policy.g,
                                      policy.rounding)
        torch.cuda.synchronize()
        mismatches = int((got.view(torch.int32) !=
                          want.view(torch.int32)).sum())
        n_sub = int(((x != 0) & (x.abs() < 1.1754944e-38)).sum())
        emit({"phase": "bfp_bitexact", "shape": list(shape),
              "mismatching_bits_elements": mismatches,
              "subnormal_inputs": n_sub, "ok": mismatches == 0})
        check(mismatches == 0, f"BFP kernel differs from the plain version "
                               f"in {mismatches} elements at {shape}")
        worst = max(worst, float((got - want).abs().max()))
    return worst


# --------------------------------------------------------------------------
# phase 4: the fused GEMM against its plain version
# --------------------------------------------------------------------------

def gemm_operands(M: int, K: int, N: int, seed: int):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=DEV)
    w = torch.randn((K, N), generator=gen, device=DEV) / math.sqrt(K)
    if N == 151936:
        # the tied head passes emb.T: a transposed (N, K) table, read in place
        w = (torch.randn((N, K), generator=gen, device=DEV) * 0.02).T
    return x, w


def folded(ref, x, w, policy):
    xq = ref.bfp_fake_quant_ref(x, policy.b_m, policy.g)
    wq = ref.bfp_fake_quant_ref(w.T, policy.b_m, policy.g).T
    return xq, wq


def phase_gemm(ops, ref, policy):
    worst = 0.0
    for M in GEMM_M:
        for K, N in GEMM_KN:
            x, w = gemm_operands(M, K, N, seed=M * 7 + K + N)
            got = ops.mirage_matmul_fused(x, w, policy)
            want = ref.mirage_gemm_ref(x, w, policy.b_m, policy.g)
            xq, wq = folded(ref, x, w, policy)
            tol = 1e-5 * (xq.abs() @ wq.abs()) + 1e-30
            err = (got - want).abs()
            bad = int((err > tol).sum())
            torch.cuda.synchronize()
            emit({"phase": "gemm_vs_plain", "M": M, "K": K, "N": N,
                  "w_layout": "NK" if not w.is_contiguous() else "KN",
                  "max_abs_err": float(err.max()),
                  "max_err_over_tol": float((err / tol).max()),
                  "ok": bad == 0})
            check(bad == 0, f"GEMM kernel outside |got-ref| <= 1e-5 "
                            f"(|xq|@|wq|) + 1e-30 in {bad} elements at "
                            f"M={M} K={K} N={N}")
            worst = max(worst, float(err.max()))
    return worst


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
              "D": D, "window": window, "max_abs_err": float(err.max()),
              "ok": ok})
        check(ok, f"flash kernel outside rtol=atol=2e-5 at B={B} L={L} "
                  f"window={window}")
        worst = max(worst, float(err.max()))
    return worst


# --------------------------------------------------------------------------
# phase 6: the slice — full-width qwen2-0.5b served on the card
# --------------------------------------------------------------------------

def make_requests(Request, vocab: int):
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)
                                               ).astype(np.int32),
                    max_tokens=MAX_TOKENS) for i, n in enumerate(lens)]


def phase_slice(ops):
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.models import build_model
    from repro_torch.runtime.server import LMServer, Request

    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, get_policy("mirage"), device=DEV,
                        generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    cap = PROMPT_LENS[1] + MAX_TOKENS + 4

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

    profile_ticks(model, cap, reqs, LMServer)
    compare_with_cpu(model, reqs[0].prompt, cap)
    return launches, batches, steps


def profile_ticks(model, cap, reqs, LMServer, n_ticks: int = 3):
    """Device time by kernel over a few steady decode ticks (torch.profiler)
    and the device's idle share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

    server = LMServer(model, cap=cap, batch_slots=SLOTS)
    for r in reqs[:SLOTS]:
        r = dataclasses.replace(r, tokens_out=[])
        server.submit(r)
    server.tick()                      # admission + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            server.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for avg in prof.key_averages():
        dev_us = getattr(avg, "self_device_time_total", 0.0)
        if dev_us > 0:
            by_kernel[avg.key] = by_kernel.get(avg.key, 0.0) + dev_us
    busy_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "decode_tick_profile", "ticks": n_ticks,
          "wall_ms_per_tick": wall_ms / n_ticks,
          "device_busy_ms_per_tick": busy_ms / n_ticks,
          "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "top_device_ms_per_tick": {k[:80]: v / 1e3 / n_ticks
                                     for k, v in top}})


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
# phase 7: timing at the slice shapes
# --------------------------------------------------------------------------

def phase_timing(ops, ref, policy, per_tick):
    rows = {"mirage_gemm": [], "flash_attention": [], "bfp_quantize": []}
    for M in GEMM_M:
        for K, N in GEMM_KN:
            x, w = gemm_operands(M, K, N, seed=1)
            xq, wq = folded(ref, x, w, policy)
            t_b, by = bound(4.0 * (M * K + K * N + M * N), 2.0 * M * N * K)
            rows["mirage_gemm"].append({
                "M": M, "K": K, "N": N,
                # launches of this (K, N) per decode tick and per prefill
                # batch; M is the slots at decode, batch x bucket at prefill
                "launches_per_step": per_tick[(K, N)],
                "ms": time_ms(lambda: ops.mirage_matmul_fused(x, w, policy)),
                "plain_ms": time_ms(lambda: ref.mirage_gemm_ref(
                    x, w, policy.b_m, policy.g)),
                "library_ms": time_ms(lambda: torch.matmul(xq, wq)),
                "bound_ms": t_b, "bound_by": by})
    for i, (B, L, H, Kv, D, window) in enumerate(FLASH_CASES):
        q, k, v = flash_operands(B, L, H, Kv, D, seed=7 + i)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pos = torch.arange(L, device=DEV)
        allowed = pos[:, None] >= pos[None, :]
        if window is not None:
            allowed &= pos[:, None] - pos[None, :] < window
        pairs = int(allowed.sum())          # (q, k) pairs this data needs
        t_b, by = bound(4.0 * (2 * B * L * H * D + 2 * B * L * Kv * D),
                        4.0 * B * H * pairs * D)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows["flash_attention"].append({
            "B": B, "L": L, "H": H, "Kv": Kv, "D": D, "window": window,
            "launches_per_prefill_batch": 24, "launches_per_decode_tick": 0,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, True, window)),
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(
                q, k, v, True, window)),
            "library_ms": time_ms(lambda: sdpa(
                qt, kt, vt, attn_mask=allowed, enable_gqa=True)),
            "bound_ms": t_b, "bound_by": by})
    for rows_k, k_dim in ((4096, 4864), (8, 896)):
        x = bfp_inputs(rows_k, k_dim, seed=3)
        t_b, by = bound(8.0 * rows_k * k_dim, 0.0)
        rows["bfp_quantize"].append({
            # on the serving path the quantizer runs inside mirage_gemm
            "rows": rows_k, "K": k_dim, "launches_per_step": 0,
            "ms": time_ms(lambda: ops.bfp_fake_quant(x, policy)),
            "plain_ms": time_ms(lambda: ref.bfp_fake_quant_ref(
                x, policy.b_m, policy.g)),
            "library_ms": None, "bound_ms": t_b, "bound_by": by})
    for name, shapes in rows.items():
        for row in shapes:
            emit({"phase": "timing", "kernel": name, **row})
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

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build.extension()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "build_dir": str(build.BUILD_DIR)})

    policy = get_policy("mirage")
    err_bfp = phase_bfp(ops, ref, policy)
    err_gemm = phase_gemm(ops, ref, policy)
    err_flash = phase_flash(ops, ref)
    launches, batches, steps = phase_slice(ops)
    rows = phase_timing(ops, ref, policy, GEMM_PER_STEP)

    def entry(kernel, source, replaces, err, main_row):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches[kernel],
                "max_abs_err": err, **{k: main_row[k] for k in keys},
                "ok": True, "shape": {k: v for k, v in main_row.items()
                                      if k not in keys}}

    # the GEMM's headline shape: the tied head at decode, its largest launch
    head = max((r for r in rows["mirage_gemm"] if r["M"] == SLOTS),
               key=lambda r: r["N"])
    emit({"kernels": [
        entry("mirage_gemm", "mirage_gemm.cu",
              "src/repro/kernels/mirage_gemm.py:50", err_gemm, head),
        entry("flash_attention", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:81", err_flash,
              rows["flash_attention"][0]),
        entry("bfp_quantize", "bfp_quantize.cu",
              "src/repro/kernels/bfp_quantize.py:55", err_bfp,
              rows["bfp_quantize"][0]),
    ], "main_path": {"prefill_batches": batches, "decode_steps": steps,
                     "note": "bfp_quantize runs inside mirage_gemm as its "
                             "prologue (bfp.cuh); its standalone launch "
                             "exists for the bit-exact check"}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
