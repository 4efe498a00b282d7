"""Public wrappers of the hand-written kernels (port of ``repro.kernels.ops``).

The operands' device decides the route. CPU tensors take the kernel's plain
PyTorch version (:mod:`repro_torch.kernels.ref`); CUDA tensors launch the
kernel or raise. There is no fallback from the card to a plain version.

Each wrapper checks device, dtype, shape and contiguity, reshapes leading
dims away, allocates the output, and adds one to its entry of
:data:`LAUNCHES` where it launches. The TPU wrappers' padding to block
multiples is done inside the kernels, whose edge tiles load zeros.

Every wrapper is forward-only: its output is a fresh tensor with no
``grad_fn``. Called with grad mode on and an input that requires grad, it
raises rather than cut the graph; training differentiates through
:class:`repro_torch.core.gemm.MirageMatmul` (the GEMM) and the plain
:func:`repro_torch.models.attention.chunked_attention` (attention).
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analog.channel import adc_step
from repro_torch.core.precision import MiragePolicy
from repro_torch.kernels import ref
from repro_torch.kernels.build import extension

#: launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"bfp_quantize": 0, "mirage_gemm": 0,
                            "gemm_stream_prep": 0,
                            "flash_attention": 0, "rns_matmul": 0,
                            "rns_matmul_channel": 0, "rrns_decode": 0}
# the serving engine's prefill worker thread launches beside the decode
# thread; an unlocked ``+=`` could lose a count between them
_LAUNCH_LOCK = threading.Lock()

#: the GEMM kernel's step along K, and the most quantized x values its
#: decode route holds in shared memory (csrc/mirage_gemm.cu)
GEMM_BK = 64
GEMM_DECODE_X_VALUES = 16384
GEMM_DECODE_BLOCKS_PER_SM = 4
#: the decode route's copy ring (stages x 4 float4 a thread), and the
#: shared memory of an H100 SM with the 1 KB each resident block reserves
GEMM_DECODE_RING_BYTES_PER_THREAD = 4 * 4 * 16
SM_SHARED_BYTES, BLOCK_RESERVED_SHARED_BYTES = 228 * 1024, 1024
#: SMs of an H100 SXM (the plan takes the card's own count where it runs)
H100_SMS = 132
#: the stream route (csrc/mirage_gemm_stack.cu): columns of a work unit,
#: threads a block (four consumer warps and a producer), the ring's stages
#: where every block takes at most one unit (static) or where blocks take
#: their units from a counter (dynamic), the most K rows of a dynamic unit
#: (512 KB of weights) and the fewest of any split one, the most (expert,
#: split) pairs its blocks list, and the most blocks an SM
STREAM_COLS, STREAM_THREADS = 128, 160
STREAM_STAGES_STATIC, STREAM_STAGES_DYNAMIC = 4, 6
STREAM_MAX_ROWS, STREAM_MIN_ROWS = 1024, 256
STREAM_MAX_PAIRS, STREAM_MAX_BLOCKS_PER_SM = 4096, 8
#: the most dynamic shared memory a block takes (csrc/bindings.cpp checks it)
STREAM_MAX_SMEM_BYTES = 227 * 1024

#: bounds of the tables the residue kernels take (csrc/rns.cuh)
RNS_MAX_MODULI = 8
RRNS_MAX_TOTAL = 8
RRNS_MAX_SUBSETS = 64


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` to :data:`LAUNCHES`: a replayed CUDA graph launches
    the kernels its capture recorded without running their wrappers."""
    with _LAUNCH_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU operands, False for all-CUDA ones; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    devices = {t.device for t in tensors}
    if kinds != {"cuda"} or len(devices) != 1:
        raise ValueError(f"operands must all lie on the CPU or all on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    return False


def _forward_only(kernel: str, route: str, *tensors) -> None:
    """Refuse a call whose output autograd would silently detach."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} is forward-only and its output has no grad_fn, so "
            f"the gradient would be lost; differentiate through {route}, or "
            f"call it under torch.no_grad()")


_GEMM_ROUTE = "repro_torch.core.gemm.mirage_matmul (MirageMatmul)"
_ATTN_ROUTE = ("repro_torch.models.attention.chunked_attention (the "
               "default, LMCallOptions.use_flash_kernel=False)")
_NO_ROUTE = "nothing: no autograd route exists for this kernel"


def _check_cuda_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _truncate(rounding: str) -> bool:
    if rounding == "nearest":
        return False
    if rounding == "truncate":
        return True
    raise ValueError(f"the BFP kernels round 'nearest' or 'truncate', got "
                     f"{rounding!r} (stochastic rounding is training-only)")


#: the largest group the BFP quantizer's vector route takes (g/4 lanes,
#: padded to a power of two, share one warp), and its blocks per SM
BFP_VECTOR_MAX_G = 128
BFP_VECTOR_BLOCKS_PER_SM = 8


def bfp_quant_plan(K: int, g: int, aligned: bool = True) -> str:
    """The route of ``csrc/bfp_quantize.cu`` for rows of K floats in groups
    of g: ``"vector"`` (float4 per lane, group max by warp shuffles) where
    g % 4 == 0, g <= 128, K % 4 == 0 and the operands are 16-byte aligned,
    else ``"scalar"`` (one thread per group)."""
    vector = g % 4 == 0 and g <= BFP_VECTOR_MAX_G and K % 4 == 0 and aligned
    return "vector" if vector else "scalar"


def bfp_fake_quant(x: torch.Tensor, policy: MiragePolicy) -> torch.Tensor:
    """BFP(b_m, g) fake quantization along the last axis (any rank)."""
    _forward_only("bfp_fake_quant", _NO_ROUTE + " (the quantizer's "
                  "gradient is zero almost everywhere)", x)
    if _on_cpu(x):
        return ref.bfp_fake_quant_ref(x, policy.b_m, policy.g,
                                      policy.rounding)
    _check_cuda_operand(x, "x")
    truncate = _truncate(policy.rounding)
    xf = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(xf)
    if xf.numel():
        route = bfp_quant_plan(xf.shape[1], policy.g,
                               xf.data_ptr() % 16 == 0 and
                               out.data_ptr() % 16 == 0)
        blocks = BFP_VECTOR_BLOCKS_PER_SM * sm_count(x.device)
        extension().bfp_fake_quant(xf, out, policy.g, policy.b_m, truncate,
                                   route == "vector", blocks)
        add_launch_counts({"bfp_quantize": 1})
    return out.reshape(x.shape)


class GemmPlan(NamedTuple):
    """How kernel 1 runs one GEMM or stack: the ``route`` (``"mma"``: bf16
    tensor cores; ``"decode"``: the CUDA-core split-K route, both in
    ``csrc/mirage_gemm.cu``; ``"stream"``: a stack of experts at decode,
    ``csrc/mirage_gemm_stack.cu``), threads per block (a decode block
    covers ``threads // 4`` columns), K cut into ``splits`` ranges of
    ``k_split`` rows, ``blocks`` in the first launch's grid (a decode block
    walks several column tiles where they outnumber
    GEMM_DECODE_BLOCKS_PER_SM blocks per SM; the stream route's persistent
    blocks walk the live units), and the stream route's ring ``stages``
    (0 on the other routes)."""
    route: str
    threads: int
    splits: int
    k_split: int
    blocks: int
    stages: int = 0

    @property
    def mma(self) -> bool:
        return self.route == "mma"


def stream_tile_rows(g: int) -> int:
    """Weight rows a stage of the stream route holds: whole groups."""
    return max(16, g)


def stream_smem_bytes(mt: int, bk: int, stages: int, pairs: int) -> int:
    """Dynamic shared memory of a stream-route block (the kernel's
    ``stream_smem_bytes``): the weight and x rings, a 32-byte stage record
    and barrier pair a stage, the pair list and its count, and 128 bytes to
    align the ring."""
    return 128 + stages * (bk * (STREAM_COLS + mt) * 4 + 32) + 4 * (pairs + 1)


def _stream_plan(M: int, N: int, K: int, E: int, sms: int,
                 g: int) -> Optional[GemmPlan]:
    """The stream route's split of K, ring and grid, or None where its pair
    list would not fit. Units are (expert, 128-column tile, split). The
    fewest splits that give either of two grids that balanced well on the
    H100 (PERF.md): every block one unit, the units of a dense stack
    filling 60% or more of the grid of STREAM_STAGES_STATIC-stage blocks;
    or blocks that take units from a counter, at least three a block, of
    at most STREAM_MAX_ROWS rows (a unit's time is the tail it can leave).
    Small stacks take the finest split, down to STREAM_MIN_ROWS rows. A
    unit's arithmetic depends on its own K range only, never on the grid."""
    units_k = max(1, -(-K // GEMM_BK))
    tiles = -(-N // STREAM_COLS)
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    bk = stream_tile_rows(g)

    def ring(stages: int, pairs: int) -> Tuple[int, int]:
        """The stages (at most ``stages``, at least 2) whose shared memory
        fits a block, and the grid of the blocks an SM then holds."""
        while stages > 2 and stream_smem_bytes(
                mt, bk, stages, pairs) > STREAM_MAX_SMEM_BYTES:
            stages -= 1
        smem = stream_smem_bytes(mt, bk, stages, pairs)
        return stages, sms * min(STREAM_MAX_BLOCKS_PER_SM, SM_SHARED_BYTES // (
            smem + BLOCK_RESERVED_SHARED_BYTES))

    last = max(1, units_k // (STREAM_MIN_ROWS // GEMM_BK))
    for want in range(1, last + 1):
        steps = -(-units_k // want)
        splits = -(-units_k // steps)
        pairs = E * splits
        if pairs > STREAM_MAX_PAIRS or stream_smem_bytes(
                mt, bk, 2, pairs) > STREAM_MAX_SMEM_BYTES:
            return None
        units = E * tiles * splits
        st_static, static = ring(STREAM_STAGES_STATIC, pairs)
        if 0.6 * static <= units <= static:
            return GemmPlan("stream", STREAM_THREADS, splits, steps * GEMM_BK,
                            units, st_static)
        st_dynamic, dynamic = ring(STREAM_STAGES_DYNAMIC, pairs)
        if units >= 3 * dynamic and steps * GEMM_BK <= STREAM_MAX_ROWS:
            return GemmPlan("stream", STREAM_THREADS, splits, steps * GEMM_BK,
                            dynamic, st_dynamic)
    return GemmPlan("stream", STREAM_THREADS, splits, steps * GEMM_BK,
                    min(units, static), st_static)


def gemm_plan(M: int, N: int, K: int, b_m: int,
              sms: int = H100_SMS, quant_w: bool = True,
              E: int = 1, w_nk: bool = False, aligned: bool = True,
              g: int = 16) -> GemmPlan:
    """The route, split and block size the wrapper gives kernel 1 (for a
    stack of ``E`` GEMMs of that shape, one launch over the stack).

    A stack (E > 1) at M <= 16 with the weight quantized, stored (E, K, N)
    (not ``w_nk``) with N % 4 == 0 and a 16-byte aligned base (``aligned``)
    takes the stream route (:func:`_stream_plan`). Otherwise M > 16 with
    b_m <= 8 takes the tensor-core route (64 x 64 tiles), unless the weight
    is taken as it is (``quant_w`` false: a bf16 operand would round a
    weight off its grid); the rest the decode route, whose blocks of 128,
    64 or 32 threads cover 32, 16 or 8 columns over 64-row steps (the
    widest block that still leaves two blocks per SM to split K over). K
    is then split until the grid holds about two blocks per SM, into
    ranges of whole 64-row steps. The E stacked GEMMs count as E times the
    tiles; their decode-route grid holds one wave of the blocks that the
    shared memory (copy ring and quantized x) lets reside on an SM, up to
    four."""
    if E > 1 and M <= 16 and quant_w and not w_nk and N % 4 == 0 and \
            aligned:
        plan = _stream_plan(M, N, K, E, sms, g)
        if plan is not None:
            return plan
    units = max(1, -(-K // GEMM_BK))
    target = 2 * sms
    mma = M > 16 and b_m <= 8 and quant_w
    if mma:
        threads = 256
        tiles = -(-N // 64) * -(-M // 64) * E
        max_steps = units
    else:
        m_tiles = -(-M // 16) * E
        threads = 32
        for t in (128, 64):
            if -(-N // (t // 4)) * m_tiles * units >= target:
                threads = t
                break
        tiles = -(-N // (threads // 4)) * m_tiles
        mt = 4 if M <= 4 else 8 if M <= 8 else 16
        max_steps = GEMM_DECODE_X_VALUES // (mt * GEMM_BK)
    splits = min(units, -(-target // tiles))
    steps = min(-(-units // splits), max_steps)
    splits = -(-units // steps)
    blocks = tiles * splits
    if not mma:
        n_blocks = min(-(-N // (threads // 4)), max(
            1, decode_blocks_per_sm(M, threads, steps * GEMM_BK, E) * sms //
            (splits * m_tiles)))
        blocks = n_blocks * splits * m_tiles
    return GemmPlan("mma" if mma else "decode", threads, splits,
                    steps * GEMM_BK, blocks)


def decode_blocks_per_sm(M: int, threads: int, k_split: int,
                         E: int = 1) -> int:
    """Blocks per SM the decode route's grid is sized for: four, or, for a
    stack (E > 1), as many as the shared memory holds, so that the stack's
    blocks run in one wave (csrc/mirage_gemm.cu ``launch_decode``)."""
    if E == 1:
        return GEMM_DECODE_BLOCKS_PER_SM
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    smem = GEMM_DECODE_RING_BYTES_PER_THREAD * threads + mt * k_split * 4
    return max(1, min(GEMM_DECODE_BLOCKS_PER_SM, SM_SHARED_BYTES // (
        smem + BLOCK_RESERVED_SHARED_BYTES)))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the plan's ``sms``)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def mirage_matmul_fused(x: torch.Tensor, w: torch.Tensor,
                        policy: MiragePolicy,
                        quantize_w: bool = True) -> torch.Tensor:
    """Fused BFP-quantize + GEMM: ``x (..., K) @ w (K, N)`` (paper dataflow
    steps 2-9 in one kernel), or a stack of E of them, ``x (E, M, K) @
    w (E, K, N) -> (E, M, N)`` (the MoE layer's expert GEMMs, a vmap of the
    GEMM in the JAX package), in one launch over the stack.

    On the card ``w`` may be a contiguous ``(K, N)`` matrix or the transpose
    of a contiguous ``(N, K)`` one (the tied head passes ``emb.T``, the dX
    GEMM ``w.T``), stacked alike; the kernel reads either in place. ``x``
    is contiguous, or the transpose of a contiguous matrix or stack (the
    dW GEMM's ``X^T``, which contracts over the tokens, per expert for a
    stack), which is copied once into a contiguous one here.
    ``quantize_w=False`` takes the weight as it is (already on its BFP
    grid: the weight-stationary backward reads it transposed).
    ``compute_dtype`` does not change the
    kernel: BFP(b_m <= 8) values are exact in bf16 and every product of two
    is exact in f32. Where :func:`gemm_plan` splits K, the partials go to a
    workspace allocated here and a second launch of the same call adds them
    in split order (one count in :data:`LAUNCHES`). A stack at decode takes
    the stream route, whose pre-pass (x quantized once, empty experts
    flagged) counts under ``gemm_stream_prep``.
    """
    _forward_only("mirage_matmul_fused", _GEMM_ROUTE, x, w)
    batched = w.dim() == 3
    if batched and (x.dim() != 3 or x.shape[0] != w.shape[0]):
        raise ValueError(f"a stacked w {tuple(w.shape)} takes x (E, M, K) "
                         f"of the same E, got {tuple(x.shape)}")
    if w.dim() not in (2, 3) or w.shape[-2] != x.shape[-1]:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} along K")
    if _on_cpu(x, w):
        return ref.mirage_gemm_ref(x, w, policy.b_m, policy.g,
                                   policy.rounding, policy.compute_dtype,
                                   quantize_w)
    if not x.is_contiguous() and x.transpose(-1, -2).is_contiguous():
        x = x.contiguous()      # X^T of the dW GEMM: one transposing copy
    _check_cuda_operand(x, "x")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32 for the CUDA kernel, got {w.dtype}")
    wt = w.transpose(-1, -2)
    if w.is_contiguous():
        w_nk, wk = False, w
    elif wt.is_contiguous():
        w_nk, wk = True, wt
    else:
        raise ValueError("w must be a contiguous (K, N) matrix or the "
                         "transpose of a contiguous (N, K) one (or a "
                         "stack of either)")
    K, N = w.shape[-2:]
    E = w.shape[0] if batched else 1
    xf = x if batched else x.reshape(-1, K)
    M = xf.shape[-2]
    out = torch.empty(xf.shape[:-1] + (N,), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        plan = gemm_plan(M, N, K, policy.b_m, sm_count(x.device),
                         quantize_w, E, w_nk, wk.data_ptr() % 16 == 0,
                         policy.g)
        launch_gemm_plan(xf, wk, out, plan, policy, w_nk, quantize_w)
        add_launch_counts({"mirage_gemm": 1} if plan.route != "stream" else
                          {"mirage_gemm": 1, "gemm_stream_prep": 1})
    return out if batched else out.reshape(x.shape[:-1] + (N,))


def launch_gemm_plan(x: torch.Tensor, wk: torch.Tensor, out: torch.Tensor,
                     plan: GemmPlan, policy: MiragePolicy, w_nk: bool = False,
                     quantize_w: bool = True) -> None:
    """Enqueue kernel 1 on CUDA operands as ``plan`` says, writing ``out``
    (the wrapper's launch, without its count): ``wk`` is the weight's
    contiguous storage, (K, N), or (N, K) where ``w_nk``, stacked alike for
    a 3-D ``x``. Allocates the split-K workspace and, on the stream route,
    the quantized x and the live flags its pre-pass writes."""
    ws = out if plan.splits == 1 else torch.empty(
        (plan.splits,) + out.shape, dtype=torch.float32, device=out.device)
    truncate = _truncate(policy.rounding)
    if plan.route != "stream":
        extension().mirage_gemm(x, wk, out, ws, w_nk, policy.g, policy.b_m,
                                truncate, quantize_w, plan.mma, plan.threads,
                                plan.splits, plan.k_split)
        return
    E, M, K = x.shape
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    xq = torch.empty((E, -(-K // GEMM_BK) * GEMM_BK, mt),
                     dtype=torch.float32, device=x.device)
    live = torch.empty((E * plan.splits + 1,), dtype=torch.int32,
                       device=x.device)
    extension().mirage_gemm_stream(x, wk, out, ws, xq, live, policy.g,
                                   policy.b_m, truncate, plan.splits,
                                   plan.k_split, plan.stages, plan.blocks)


#: the head dims ``csrc/flash_attention.cu`` is instantiated at
FLASH_HEAD_DIMS = (16, 32, 64, 80, 96, 128)


def flash_head_dim(D: int) -> int:
    """The flash kernel's instance for head dim D: the smallest instance
    that holds it (the others are zero-padded up to it)."""
    for inst in FLASH_HEAD_DIMS:
        if D <= inst:
            return inst
    raise ValueError(f"the flash kernel takes head_dim <= "
                     f"{FLASH_HEAD_DIMS[-1]}, got {D}; larger head dims wait "
                     f"in ROADMAP.md queue 2 (kernel 3)")


def flash_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 attend) -> torch.Tensor:
    """``attend(q, k, v, sm_scale)`` at the flash instance's head dim:
    q, k and v get zero columns up to :func:`flash_head_dim` (they add
    nothing to Q K^T), the scale stays 1/sqrt(D) of the true D, and the
    padded columns of the output (those of v) are sliced off."""
    D = q.shape[-1]
    Dk = flash_head_dim(D)
    sm_scale = 1.0 / math.sqrt(D)
    if Dk == D:
        return attend(q, k, v, sm_scale)
    pad = (0, Dk - D)
    F = torch.nn.functional
    out = attend(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), sm_scale)
    return out[..., :D].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA flash attention over a full sequence at positions 0..L-1.

    q: (B, Lq, H, D) with rope applied; k/v: (B, S, Kv, D). Query head h
    reads kv head h // (H // Kv). Returns (B, Lq, H, D). On the card any
    D <= 128 runs (:func:`flash_padded`); larger ones raise."""
    _forward_only("flash_attention", _ATTN_ROUTE, q, k, v)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal, window)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_cuda_operand(t, name)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q must be (B, Lq, H, D) and k/v (B, S, Kv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H, Kv = q.shape[2], k.shape[2]
    if H % Kv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Kv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")

    def launch(qp, kp, vp, sm_scale):
        out = torch.empty_like(qp)
        if out.numel():
            extension().flash_attention(qp, kp, vp, out, causal,
                                         -1 if window is None else window,
                                         sm_scale)
            add_launch_counts({"flash_attention": 1})
        return out

    return flash_padded(q, k, v, launch)


# --------------------------------------------------------------------------
# residue GEMM, its fused readout channel, and the RRNS decode
# --------------------------------------------------------------------------

def _mod_major(t: torch.Tensor) -> bool:
    """Each modulus's part of ``t (n_mod, S, ., .)`` is contiguous (any
    stride between moduli: a block of whole experts sliced from a stack)."""
    return t.dim() == 4 and (t.shape[0] == 1 or t[0].is_contiguous())


def _check_residue_operands(x_res: torch.Tensor, w_res: torch.Tensor,
                            moduli: Sequence[int]) -> None:
    if x_res.dim() != 4 or w_res.dim() != 4 or \
            x_res.shape[:2] != w_res.shape[:2] or \
            x_res.shape[3] != w_res.shape[2]:
        raise ValueError(f"x_res must be (n_mod, S, M, g) and w_res "
                         f"(n_mod, S, g, N), got {tuple(x_res.shape)}, "
                         f"{tuple(w_res.shape)}")
    for t, name in ((x_res, "x_res"), (w_res, "w_res")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 for the CUDA kernel, "
                            f"got {t.dtype}")
        if not _mod_major(t):
            raise ValueError(f"{name}: each modulus's part must be "
                             f"contiguous for the CUDA kernel")
    if len(moduli) != x_res.shape[0]:
        raise ValueError(f"{len(moduli)} moduli for {x_res.shape[0]} "
                         f"residue channels")
    if not 1 <= x_res.shape[3] <= 64 or len(moduli) > RNS_MAX_MODULI:
        raise ValueError(f"the residue kernel takes g in [1, 64] and at "
                         f"most {RNS_MAX_MODULI} moduli, got g="
                         f"{x_res.shape[3]}, {len(moduli)} moduli")


def rns_group_matmul(x_res: torch.Tensor, w_res: torch.Tensor,
                     moduli: Sequence[int]) -> torch.Tensor:
    """Group-batched residue GEMM, ``(x . w) mod m`` per (modulus, slot):
    x_res (n_mod, S, M, g), w_res (n_mod, S, g, N) int32 residues in [0, m)
    -> (n_mod, S, M, N) int32, the slots the G groups of one GEMM or the E
    x G (expert, group) slots of an expert stack. One launch covers every
    slot; on the card each modulus's part of an operand must be contiguous
    (any stride between moduli)."""
    _forward_only("rns_group_matmul", _NO_ROUTE + " (integer residues)",
                  x_res, w_res)
    if _on_cpu(x_res, w_res):
        return ref.rns_matmul_ref(x_res, w_res, moduli)
    _check_residue_operands(x_res, w_res, moduli)
    nm, G, M, _ = x_res.shape
    out = torch.empty((nm, G, M, w_res.shape[-1]), dtype=torch.int32,
                      device=x_res.device)
    if out.numel():
        extension().rns_matmul(x_res, w_res, out, [int(m) for m in moduli])
        add_launch_counts({"rns_matmul": 1})
    return out


def adc_steps(moduli: Sequence[int], adc_bits: Optional[int]
              ) -> Tuple[float, ...]:
    """Per-modulus ADC grid step as its f32 value (0.0: identity)."""
    return tuple(float(np.float32(adc_step(m, adc_bits))) for m in moduli)


def rns_group_matmul_channel(x_res: torch.Tensor, w_res: torch.Tensor,
                             moduli: Sequence[int], noise: torch.Tensor,
                             adc_bits: Optional[int] = None,
                             count_flips: bool = False):
    """:func:`rns_group_matmul` with the readout channel fused in: each
    residue gets its detector noise, pre-scaled to the per-modulus sigmas,
    is rounded and wrapped mod m, then re-gridded onto the ``adc_bits`` ADC
    levels. ``noise`` (n_mod, P, M, N) f32 has a group period P dividing
    the slots S: slot s reads ``noise[:, s % P]``, so one draw at one
    expert's shape (P = G) serves a whole stack of experts.

    ``count_flips=True`` returns ``(residues, flips)``: ``flips`` (n_mod,)
    int64 counts, per modulus, the residues the noise moved (wrapped
    against clean, before the ADC), which the kernel counts itself."""
    _forward_only("rns_group_matmul_channel",
                  _NO_ROUTE + " (integer residues)", x_res, w_res, noise)
    if _on_cpu(x_res, w_res, noise):
        return ref.rns_matmul_channel_ref(x_res, w_res, moduli, noise,
                                          adc_bits, count_flips)
    _check_residue_operands(x_res, w_res, moduli)
    nm, S, M, _ = x_res.shape
    shape = (nm, S, M, w_res.shape[-1])
    if noise.dim() != 4 or noise.shape[0] != nm or \
            tuple(noise.shape[2:]) != shape[2:] or \
            noise.shape[1] < 1 or S % noise.shape[1]:
        raise ValueError(f"noise must be (n_mod, P, M, N) with P dividing "
                         f"the {S} slots, got {tuple(noise.shape)}")
    if noise.dtype != torch.float32 or not _mod_major(noise):
        raise TypeError("noise must be float32, each modulus's part "
                        "contiguous, for the CUDA kernel")
    out = torch.empty(shape, dtype=torch.int32, device=x_res.device)
    flips = torch.zeros((nm if count_flips else 0,), dtype=torch.int64,
                        device=x_res.device)
    if out.numel():
        extension().rns_matmul_channel(x_res, w_res, noise, out, flips,
                                       [int(m) for m in moduli],
                                       list(adc_steps(moduli, adc_bits)))
        add_launch_counts({"rns_matmul_channel": 1})
    return (out, flips) if count_flips else out


def rns_residue_matmul(*args, **kwargs):
    """The ungrouped residue GEMM of ``repro.kernels.ops`` (tests and
    benchmarks only) is not ported yet."""
    raise NotImplementedError(
        "rns_residue_matmul waits in ROADMAP.md queue 2 (the grouped "
        "rns_group_matmul runs the serving path)")


def _rrns_table_words(tables) -> np.ndarray:
    """The decode tables packed in the field order of ``csrc/rns.cuh``'s
    RrnsTables, every value as the f32 that rrns_decode.py:88-96 builds."""
    S, n_total = tables.weights.shape
    weight = np.zeros((RRNS_MAX_SUBSETS, RRNS_MAX_TOTAL), np.float32)
    weight[:S, :n_total] = tables.weights
    sub = np.zeros((4, RRNS_MAX_SUBSETS), np.float32)
    sub[0, :S] = tables.subset_M
    sub[1, :S] = (1.0 / tables.subset_M).astype(np.float32)
    sub[2, :S] = tables.subset_psi
    sub[3, :S] = tables.subset_psi + 1 - tables.subset_M
    mods = np.asarray(tables.moduli, np.float32)
    minv = np.zeros((2, RRNS_MAX_TOTAL), np.float32)
    minv[0, :n_total] = mods
    minv[1, :n_total] = 1.0 / mods
    binom = np.zeros(RRNS_MAX_TOTAL + 1, np.float32)
    binom[:len(tables.binom)] = tables.binom
    tail = np.asarray([tables.psi, n_total, tables.n_required, S],
                      np.float32)
    return np.concatenate([weight.ravel(), sub.ravel(), minv.ravel(), binom,
                           tail])


@functools.lru_cache(maxsize=16)
def _host_tables(moduli: Tuple[int, ...], n_required: int,
                 psi: int) -> torch.Tensor:
    """The packed tables of one moduli set, on the host: the kernel takes
    them by value as its parameter. Checked once per set: the decode stops
    at the first subset with the largest vote, which is right only while
    the votes ``binom`` rise strictly with the consistency count."""
    from repro_torch.analog import rrns
    tables = rrns.get_tables(moduli, n_required, psi)
    if any(a >= b for a, b in zip(tables.binom, tables.binom[1:])):
        raise ValueError(f"the decode kernel's early stop needs strictly "
                         f"increasing votes, got binom={tables.binom}")
    return torch.from_numpy(_rrns_table_words(tables))


def rrns_decode(residues: torch.Tensor, tables
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused RRNS majority decode of (n_total, ...) int32 residues over
    ``tables.moduli``: returns ``(decoded int32, votes f32)`` of shape
    ``residues.shape[1:]`` (value 0 and votes -1 where no subset is legal).
    On the card the tables must be ``f32_exact``."""
    _forward_only("rrns_decode", _NO_ROUTE + " (integer residues)",
                  residues)
    if _on_cpu(residues):
        return ref.rrns_decode_ref(residues, tables)
    if not tables.f32_exact:
        raise ValueError(
            "rrns_decode_pallas runs in f32 and needs every reconstruction "
            "bound inside the 2^24 exact-integer window; this moduli set "
            f"({tables.moduli}) exceeds it — use the jnp rrns_decode, whose "
            "int32 fallback handles large moduli")
    n_total = residues.shape[0]
    if n_total != len(tables.moduli) or n_total > RRNS_MAX_TOTAL or \
            tables.n_subsets > RRNS_MAX_SUBSETS:
        raise ValueError(f"the decode kernel takes at most {RRNS_MAX_TOTAL} "
                         f"moduli and {RRNS_MAX_SUBSETS} subsets; got "
                         f"{n_total} residue rows, {tables.n_subsets} "
                         f"subsets over {tables.moduli}")
    if residues.dtype != torch.int32 or not residues.is_contiguous():
        raise TypeError("residues must be contiguous int32 for the CUDA "
                        "kernel")
    shape = residues.shape[1:]
    flat = residues.reshape(n_total, -1)
    E = flat.shape[1]
    decoded = torch.empty(E, dtype=torch.int32, device=residues.device)
    votes = torch.empty(E, dtype=torch.float32, device=residues.device)
    if E:
        words = _host_tables(tuple(tables.moduli), tables.n_required,
                             tables.psi)
        extension().rrns_decode(flat, words, decoded, votes)
        add_launch_counts({"rrns_decode": 1})
    return decoded.reshape(shape), votes.reshape(shape)
