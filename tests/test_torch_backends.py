"""PyTorch port: the group-dot backends (``mirage_faithful`` with
``grouped.grouped_dot``, the seed oracles ``mirage_faithful_ref`` and
``mirage_rns_ref``), the card's group-block plan of ``mirage_rns``, and the
flash kernel's head dims, against the JAX package.

The group-dot backends are bitwise equal to JAX: every group dot is exact,
and up to 32 groups both sum them left to right. The card's blocked RNS
route runs here with the plain residue op in place of the kernel. Flash:
the plain version at head dims 16, 80 and 128 against the JAX kernel in
interpret mode, and the wrapper's pad-and-slice in front of it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.core import bfp as jbfp
from repro.core import gemm as jgemm
from repro.core.precision import get_policy as jpolicy
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.core import gemm, rns
from repro_torch.core.backends import grouped, mirage_rns
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ops, ref


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _on_grid(w, b_m=4, g=16):
    """w (K, N) on its BFP grid along K (a weight-stationary operand)."""
    return np.asarray(jbfp.bfp_fake_quant(jnp.asarray(w.T), b_m, g).T).copy()


# --------------------------------------------------------------------------
# mirage_faithful and the seed oracles, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mirage_faithful", "mirage_faithful_ref",
                                  "mirage_rns_ref"])
@pytest.mark.parametrize("K", [16, 37, 80])          # 1, 3 (ragged), 5 groups
@pytest.mark.parametrize("stationary", [False, True],
                         ids=["per_call", "weight_stationary"])
def test_group_dot_backends_bitwise(mode, K, stationary):
    x, w = _rand((2, 3, K), 1), _rand((K, 11), 2, 0.2)
    if stationary:
        w = _on_grid(w)
    kw = dict(assume_quantized_weights=stationary)
    want = np.asarray(jgemm.mirage_matmul_nograd(
        jnp.asarray(x), jnp.asarray(w), jpolicy(mode, **kw)))
    got = gemm.mirage_matmul_nograd(_t(x), _t(w), get_policy(mode, **kw))
    assert got.shape == (2, 3, 11)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("group_block", [-1, 2, 3])
def test_grouped_dot_regimes_bitwise(group_block):
    """One batched product, and blocks (a ragged last one included) added
    in block order, as the JAX package's scan."""
    x, w = _rand((7, 96), 3), _rand((96, 10), 4, 0.2)
    p = dict(group_block=group_block)
    want = np.asarray(jgemm.mirage_matmul_nograd(
        jnp.asarray(x), jnp.asarray(w), jpolicy("mirage_faithful", **p)))
    got = gemm.mirage_matmul_nograd(_t(x), _t(w),
                                    get_policy("mirage_faithful", **p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_faithful_gradients_match_jax_vjp():
    x, w, dout = _rand((2, 5, 48), 5), _rand((48, 9), 6, 0.2), \
        _rand((2, 5, 9), 7)
    jp = jpolicy("mirage_faithful")
    # jitted: one XLA compile instead of the eager op-by-op ones
    want, jdx, jdw = jax.jit(lambda a, b, d: (lambda y, f: (y,) + f(d))(
        *jax.vjp(lambda a, b: jgemm.mirage_matmul(a, b, jp), a, b)))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(dout))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = gemm.mirage_matmul(tx, tw, get_policy("mirage_faithful"))
    got.backward(_t(dout))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jdw))


def test_rns_dot_reconstruct_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(-15, 16, size=(8, 16)).astype(np.float32)
    w = rng.integers(-15, 16, size=(16, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        rns.rns_dot_reconstruct(_t(x), _t(w), 5).numpy(), x @ w)


# --------------------------------------------------------------------------
# mirage_rns on the card: kernel 4 over group blocks
# --------------------------------------------------------------------------

def test_card_group_block_plan_at_the_training_shapes():
    """One launch wherever the residues fit the budget (every layer GEMM of
    a 256-token step, and the serving shapes); the tied head in blocks."""
    plan = mirage_rns.card_group_block
    d, dff, V, T = 896, 4864, 151936, 256
    for M, K, N in ((T, d, dff), (T, dff, d), (T, d, d), (d, T, dff),
                    (512, d, dff), (4, d, V)):
        assert plan(3, K // 16, M, N) == K // 16
    assert plan(3, d // 16, T, V) == 4            # head forward: 14 blocks
    assert plan(3, V // 16, T, d) == 780          # head dX: 13 blocks
    assert plan(3, T // 16, d, V) == 1            # head dW: 16 blocks of 1
    assert 3 * 4 * T * V * 4 <= mirage_rns.CARD_RESIDUE_BUDGET_BYTES


def _rns_operands(M, K, N, seed):
    p = get_policy("mirage_rns")
    qx, sx, qw, sw, batch = grouped.prepare_operands(
        _t(_rand((M, K), seed)), _t(_rand((K, N), seed + 1, 0.2)), p)
    return (rns.to_rns_special(qx, p.k), rns.to_rns_special(qw, p.k), sx, sw,
            p)


@pytest.mark.parametrize("budget_groups", [1, 3, 5, 6])
def test_card_blocked_route_matches_one_launch(budget_groups):
    """The card's plan with the plain residue op in place of the kernel:
    within the GEMM's f32 bound of the unblocked result, and bit for bit
    where one block covers every group (G = 5)."""
    M, K, N = 6, 80, 13
    xr, wr, sx, sw, p = _rns_operands(M, K, N, 8)
    G = xr.shape[1]
    gb = mirage_rns.card_group_block(3, G, M, N,
                                     budget=budget_groups * 3 * M * N * 4)
    assert gb == min(budget_groups, G)
    one = grouped.scale_accumulate(
        rns.from_rns_special(grouped.residue_dots(xr, wr, p.moduli),
                             p.k).to(torch.float32), sx, sw, (M,))
    if gb < G:
        def block(xb, wb, es, gs):
            res = grouped.residue_dots(xb, wb, p.moduli)
            return rns.from_rns_special(res, p.k).to(torch.float32) \
                .reshape(1, -1, M, N)

        got = mirage_rns.run_blocks(
            *mirage_rns.as_stack(xr, wr, sx, sw, False), 1, gb, block)[0]
        exact = (sx * sw * torch.abs(rns.from_rns_special(
            grouped.residue_dots(xr, wr, p.moduli), p.k)).double()).sum(0)
        assert bool((torch.abs(got - one) <= 1e-5 * exact + 1e-30).all())
    else:
        got = gemm.mirage_matmul_nograd(
            _t(_rand((M, K), 8)), _t(_rand((K, N), 9, 0.2)),
            p.replace(group_block=gb))
        assert torch.equal(got, one)


# --------------------------------------------------------------------------
# flash attention at other head dims
# --------------------------------------------------------------------------

def _qkv(B, L, H, Kv, D, seed):
    return (_rand((B, L, H, D), seed, 0.5), _rand((B, L, Kv, D), seed + 1, 0.5),
            _rand((B, L, Kv, D), seed + 2, 0.5))


@pytest.mark.parametrize("D", [16, 80, 128])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_plain_matches_pallas_at_head_dims(D, window):
    q, k, v = _qkv(1, 20, 4, 2, D, 10)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, block_q=8,
                             block_k=8, interpret=True))
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), True, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", [8, 24, 40, 100, 128])
def test_flash_pad_and_slice_equals_unpadded(D):
    """The wrapper's zero padding up to the kernel instance, in front of
    the plain version: the unpadded result (scale 1/sqrt(true D))."""
    q, k, v = (_t(a) for a in _qkv(2, 17, 6, 3, D, 20))
    seen = []

    def attend(qp, kp, vp, sm_scale):
        seen.append((qp.shape[-1], sm_scale))
        return ref.flash_attention_ref(qp, kp, vp, True, 5, sm_scale=sm_scale)

    got = ops.flash_padded(q, k, v, attend)
    want = ref.flash_attention_ref(q, k, v, True, 5)
    assert seen == [(ops.flash_head_dim(D), 1.0 / np.sqrt(D))]
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_flash_head_dim_instances():
    assert [ops.flash_head_dim(d) for d in (1, 16, 17, 64, 65, 80, 81, 96,
                                            97, 128)] == \
        [16, 16, 32, 64, 80, 80, 96, 96, 128, 128]
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        ops.flash_head_dim(129)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_flash_head_dims(cuda):
    for i, D in enumerate((16, 24, 32, 80, 96, 128)):
        for L, window in ((1, None), (17, None), (128, 40)):
            q, k, v = (_t(a).to(cuda) for a in _qkv(2, L, 14, 2, D, 3 * i))
            torch.testing.assert_close(
                ops.flash_attention(q, k, v, True, window),
                ref.flash_attention_ref(q, k, v, True, window),
                rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_rns_blocked_route(cuda):
    """Kernel 4 over group blocks against one launch, through the plan."""
    M, K, N = 64, 896, 600
    x, w = _t(_rand((M, K), 30)).to(cuda), _t(_rand((K, N), 31, 0.2)).to(cuda)
    p = get_policy("mirage_rns")
    one = gemm.mirage_matmul_nograd(x, w, p)
    blocked = gemm.mirage_matmul_nograd(x, w, p.replace(group_block=5))
    torch.testing.assert_close(blocked, one, rtol=1e-5, atol=1e-5)
