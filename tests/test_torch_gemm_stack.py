"""PyTorch port: kernel 1 over stacks of experts: the stream route at decode
(``csrc/mirage_gemm_stack.cu``), what the CPU can hold of it, and the
training step's expert stacks (forward, dX and dW, one launch a stack).

``ops.gemm_plan`` sends the MoE decode stacks to the route and keeps every
other call on the routes it took before; the route's shared memory fits the
card at every group size and row count; and the plain version of its
pre-pass lays x out k-major and flags the live (expert, split) pairs. The
plain version of a stack with empty experts against JAX's ``vmap``
(``test_plain_stack_with_empty_experts_equals_jax_vmap``) lives in
``tests/test_torch_moe.py``, beside the batched GEMM's other JAX checks,
whose compiles it shares; the kernel itself runs on the card (the
``cuda``-marked test there, and ``chip_smoke.py``).

The training step's stacks (MoE training): the plan routes dX, dW and the
forward to the tensor-core route and the weight-stationary forward and dX
(the weight taken as it is) to the decode route; the wrapper copies a
transposed (E, K, C) x (the dW GEMM's X^T) once. On the card (``cuda``
marker; this file imports no JAX, so it runs there) each stack at both
MoE configs' training shapes equals E single-expert launches of its plan
bit for bit and a repeat, within the f32-order bound of the plain version.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.core import gemm
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ops, ref
from repro_torch.runtime import trainer

# (E, M, K, N): the MoE decode stacks (qwen3-moe gate/up and down, mixtral
# gate/up and down), then ragged E, M and K with N % 4 == 0
STREAM_SHAPES = [(128, 4, 2048, 768), (128, 4, 768, 2048),
                 (8, 4, 4096, 14336), (8, 4, 14336, 4096),
                 (5, 7, 333, 100), (3, 16, 64, 4), (2, 1, 1000, 132)]


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("E,M,K,N", STREAM_SHAPES)
def test_gemm_plan_takes_the_stream_route(E, M, K, N):
    """The stream route at the MoE decode stacks and ragged ones: its K
    splits cover K once in whole 64-row steps, its (expert, split) pairs
    fit the list its blocks hold, its ring fits a block's shared memory,
    and its persistent grid gives every block one unit (static) or holds
    three units or more a block of at most 1024 rows (dynamic)."""
    p = ops.gemm_plan(M, N, K, 4, E=E)
    assert p.route == "stream" and not p.mma
    assert p.threads == ops.STREAM_THREADS
    assert p.k_split % ops.GEMM_BK == 0
    assert (p.splits - 1) * p.k_split < K <= p.splits * p.k_split
    assert E * p.splits <= ops.STREAM_MAX_PAIRS
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    smem = ops.stream_smem_bytes(mt, 16, p.stages, E * p.splits)
    assert smem <= ops.STREAM_MAX_SMEM_BYTES
    per_sm = min(ops.STREAM_MAX_BLOCKS_PER_SM,
                 ops.SM_SHARED_BYTES // (smem + ops.BLOCK_RESERVED_SHARED_BYTES))
    units = E * -(-N // ops.STREAM_COLS) * p.splits
    if p.stages == ops.STREAM_STAGES_STATIC:
        assert p.blocks == units <= per_sm * ops.H100_SMS
    else:
        assert p.stages == ops.STREAM_STAGES_DYNAMIC
        assert p.blocks == per_sm * ops.H100_SMS <= units / 3
        assert p.k_split <= ops.STREAM_MAX_ROWS


def test_stream_plan_at_the_moe_decode_shapes():
    """qwen3-moe's gate/up (128 experts x 6 tiles = 768 units) gives every
    block one unit, no split; its down (2,048 units of 768 rows) and
    mixtral's gate/up (split in four: 3,584 units of 1,024 rows) take
    units from the counter; mixtral's down splits K in two, 512 units, one
    a block."""
    plans = [ops.gemm_plan(M, N, K, 4, E=E)
             for E, M, K, N in STREAM_SHAPES[:4]]
    assert [(p.splits, p.stages, p.blocks) for p in plans] == [
        (1, 4, 768), (1, 6, 528), (4, 6, 528), (2, 4, 512)]


@pytest.mark.parametrize("case", ["E=1", "NK", "N%4", "misaligned",
                                  "prefill", "prefill_b_m12", "as_is"])
def test_gemm_plan_keeps_the_other_routes(case):
    """E = 1, (N, K) stacks, N % 4 != 0, a misaligned base, the tensor-core
    route at M > 16 with b_m <= 8, a weight taken as it is, and M > 16 at
    b_m > 8 keep the routes they took before the stream route."""
    E, M, K, N, b_m, kw, route = {
        "E=1": (1, 4, 2048, 768, 4, {}, "decode"),
        "NK": (128, 4, 2048, 768, 4, {"w_nk": True}, "decode"),
        "N%4": (3, 5, 200, 77, 4, {}, "decode"),
        "misaligned": (8, 4, 512, 64, 4, {"aligned": False}, "decode"),
        "prefill": (128, 40, 2048, 768, 4, {}, "mma"),
        "prefill_b_m12": (8, 40, 512, 64, 12, {}, "decode"),
        "as_is": (8, 4, 512, 64, 4, {"quant_w": False}, "decode"),
    }[case]
    p = ops.gemm_plan(M, N, K, b_m, E=E, **kw)
    assert p.route == route and p.stages == 0
    assert p.mma == (route == "mma")


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("M", [1, 4, 8, 16])
def test_stream_ring_fits_the_sm(g, M):
    """At every group size g | 64 and row tile the ring of whole groups and
    the pair list of a 128-expert stack fit 227 KB (the kernel's limit),
    with at least one block an SM."""
    p = ops.gemm_plan(M, 768, 2048, 4, E=128, g=g)
    assert p.route == "stream"
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    bk = ops.stream_tile_rows(g)
    assert bk % g == 0 and 64 % bk == 0
    smem = ops.stream_smem_bytes(mt, bk, p.stages, 128 * p.splits)
    assert smem <= 227 * 1024
    assert p.blocks <= ops.STREAM_MAX_BLOCKS_PER_SM * ops.H100_SMS


@pytest.mark.parametrize("splits,k_split", [(1, 192), (3, 64)])
def test_stream_prep_ref_lays_x_out_k_major(splits, k_split):
    """The pre-pass's plain version: x quantized along K, transposed to
    (E, Kp, MT) with zeros past M and K; a pair is live where its split of
    K holds a nonzero quantized value (expert 1 is zero; expert 2 only in
    its first 64 rows of K)."""
    x = torch.from_numpy(_rand((4, 3, 150), 1))
    x[1] = 0.0
    x[2, :, :64] = 0.0
    xq, live = ref.stream_prep_ref(x, 4, 16, "nearest", splits, k_split)
    assert xq.shape == (4, 192, 4)
    q = ref.bfp_fake_quant_ref(x, 4, 16)
    assert torch.equal(xq[:, :150, :3], q.transpose(1, 2))
    assert not xq[:, 150:].any() and not xq[:, :, 3:].any()
    want = [[1], [0], [1], [1]] if splits == 1 else \
        [[1, 1, 1], [0, 0, 0], [0, 1, 1], [1, 1, 1]]
    assert live.tolist() == sum(want, [])


# --------------------------------------------------------------------------
# the training step's expert stacks
# --------------------------------------------------------------------------

# (E, C, K, N) of the expert stacks of a training step at 4 x 64 tokens and
# capacity factor 1.25: qwen3-moe's gate/up and down (C = 20), mixtral's
# (C = 80)
TRAIN_STACKS = [(128, 20, 2048, 768), (128, 20, 768, 2048),
                (8, 80, 4096, 14336), (8, 80, 14336, 4096)]
KINDS = ["dX", "dW", "fwd_as_is", "dX_as_is"]


def _stack_operands(kind, E, C, K, N, device="cpu"):
    """(a, b, quantize_w) as ``MirageMatmul`` hands a stack (E, K, N) to
    the kernel: dX reads the (E, N, K) view of the contiguous stack, dW a
    transposed (E, K, C) view of the buffers, and the weight-stationary
    forward and dX the trainer's transposed view of a contiguous (E, N, K)
    copy on its grid."""
    x = torch.from_numpy(_rand((E, C, K), 1)).to(device)
    dout = torch.from_numpy(_rand((E, C, N), 2, 1e-2)).to(device)
    w = torch.from_numpy(_rand((E, K, N), 3, 1 / np.sqrt(K))).to(device)
    if kind == "dX":
        return dout, w.transpose(1, 2), True
    if kind == "dW":
        return x.transpose(1, 2), dout, True
    wq = trainer._prequantize_params({"moe.gate": w}, get_policy("mirage"),
                                     torch.float32)["moe.gate"].detach()
    assert wq.transpose(1, 2).is_contiguous()
    return (x, wq, False) if kind == "fwd_as_is" else \
        (dout, wq.transpose(1, 2), False)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("E,C,K,N", TRAIN_STACKS)
def test_gemm_plan_at_the_training_stacks(E, C, K, N, kind):
    """At C = 20 and 80 (> 16) dX, dW and the forward take the tensor-core
    route, the weight-stationary forward and dX the decode route; dW's
    contraction is C, ragged (not a multiple of 64 or of g = 16 at 20)."""
    a, b, qw = {"dX": ((E, C, N), (E, N, K), True),
                "dW": ((E, K, C), (E, C, N), True),
                "fwd_as_is": ((E, C, K), (E, K, N), False),
                "dX_as_is": ((E, C, N), (E, N, K), False)}[kind]
    p = ops.gemm_plan(a[1], b[2], a[2], 4, E=E, quant_w=qw,
                      w_nk=kind in ("dX", "fwd_as_is"))
    assert p.route == ("mma" if qw else "decode")
    assert (p.splits - 1) * p.k_split < a[2] <= p.splits * p.k_split
    grid_m = -(-a[1] // (64 if p.mma else 16)) * E
    assert grid_m <= 65535


@pytest.mark.parametrize("kind", KINDS)
def test_fused_wrapper_takes_the_training_stacks_on_the_cpu(kind):
    """On the CPU the wrapper runs the plain version on the same operands
    (a transposed x included), per expert equal to the unbatched call."""
    E, C, K, N = 3, 5, 48, 24
    a, b, qw = _stack_operands(kind, E, C, K, N)
    pol = get_policy("mirage")
    got = ops.mirage_matmul_fused(a, b, pol, quantize_w=qw)
    assert got.shape == (E, a.shape[1], b.shape[2])
    for e in range(E):
        one = ops.mirage_matmul_fused(a[e], b[e], pol, quantize_w=qw)
        assert torch.equal(got[e], one)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("E,C,K,N", TRAIN_STACKS)
def test_cuda_training_stacks_equal_per_expert_launches(cuda, E, C, K, N,
                                                        kind):
    """One launch over the stack equals E single-expert launches of its
    plan bit for bit and a second launch, and lies within 1e-5 (|aq| @
    |bq|) of the plain version (only the f32 order of the sum differs)."""
    pol = get_policy("mirage")
    a, b, qw = _stack_operands(kind, E, C, K, N, cuda)
    got = ops.mirage_matmul_fused(a, b, pol, quantize_w=qw)
    again = ops.mirage_matmul_fused(a, b, pol, quantize_w=qw)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    w_nk = not b.is_contiguous()
    wk = b.transpose(1, 2) if w_nk else b
    M, Kc, Nout = a.shape[1], a.shape[2], b.shape[2]
    plan = ops.gemm_plan(M, Nout, Kc, 4, ops.sm_count(cuda), qw, E, w_nk,
                         wk.data_ptr() % 16 == 0)
    xc = a.contiguous()
    for e in range(E):
        one = torch.empty((1, M, Nout), device=cuda)
        ops.launch_gemm_plan(xc[e:e + 1], wk[e:e + 1], one, plan, pol,
                             w_nk, qw)
        assert torch.equal(got[e].view(torch.int32),
                           one[0].view(torch.int32))
    want = ref.mirage_gemm_ref(a, b, quantize_w=qw)
    aq = ref.bfp_fake_quant_ref(a)
    bq = ref.bfp_fake_quant_ref(b.transpose(1, 2)).transpose(1, 2) if qw \
        else b
    tol = 1e-5 * (aq.abs() @ bq.abs()) + 1e-30
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_stack_function_is_three_launches(cuda):
    """``MirageMatmul`` on a qwen3-moe gate stack: the forward, dX and dW
    are one kernel-1 launch each."""
    pol = get_policy("mirage")
    x = torch.from_numpy(_rand((128, 20, 2048), 4)).to(cuda).requires_grad_()
    w = torch.from_numpy(_rand((128, 2048, 768), 5, 0.02)).to(cuda) \
        .requires_grad_()
    ops.reset_launch_counts()
    gemm.mirage_matmul(x, w, pol).sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mirage_gemm"] == 3
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
