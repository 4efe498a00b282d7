"""PyTorch port: the MoE layer and the expert GEMMs batched over experts, vs
the JAX package.

``moe_apply`` runs on the same numpy-seeded inputs and the JAX ``moe_init``
weights in both packages, at the reduced configs' widths (8 experts, top-2,
d_model 64, moe_d_ff 32): the routing (expert ids, buffer positions, kept
pairs) and the dispatched and expert-output buffers bit for bit, the output
and the aux loss within 1e-5, at the reduced configs' dropless capacity
factor 8.0 and at the published 1.25, where pairs overflow and drop. The
batched GEMM (``mirage_matmul_auto`` with an ``(E, K, N)`` weight) equals
JAX's ``vmap`` of its GEMM bit for bit, also where experts' x rows are
zero (their rows exactly +0.0, the bits the stream route writes when it
skips them); the GEMM modes that take one (K, N) weight run a stack too. Then both reduced MoE LMs: the full
forward, the aux loss and ``LM.loss``. Card-only checks carry the ``cuda``
marker.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core import gemm as jgemm
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.lm import LMCallOptions as JOptions
from repro_torch.configs import get_config
from repro_torch.core import backends, gemm, stationary
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, moe
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import health as obs_health

E, D, F, K = 8, 64, 32, 2
ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def layer():
    """The JAX ``moe_init`` weights (numpy) and the port's ``MoE`` holding
    them."""
    p = jax.tree_util.tree_map(np.asarray,
                               jmoe.moe_init(jax.random.PRNGKey(3), D, E, F))
    m = moe.MoE(D, E, F, generator=torch.Generator().manual_seed(0),
                device=torch.device("cpu"))
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(p["router"]["w"]))
        for name in ("gate", "up", "down"):
            getattr(m, name).copy_(torch.from_numpy(p[name]))
    return p, m


def _jax_routing(p, xf, C):
    """The JAX ``moe_apply``'s routing lines, which it computes inside and
    does not return: top-k, renormalized gates, slot-major positions."""
    probs = jax.nn.softmax(jnp.matmul(xf, p["router"]["w"]), axis=-1)
    gate_vals, ids = jax.lax.top_k(probs, K)
    fill = jnp.zeros((E,), jnp.int32)
    positions = []
    for j in range(K):
        oh = jax.nn.one_hot(ids[:, j], E, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1,
                                  ids[:, j:j + 1], axis=1)[:, 0]
        positions.append(pos + fill[ids[:, j]])
        fill = fill + jnp.sum(oh, axis=0)
    positions = jnp.stack(positions, axis=1)
    return np.asarray(ids), np.asarray(positions), np.asarray(positions < C)


def _jax_moe(p, x, cf, policy):
    """JAX ``moe_apply`` with its dispatched and expert-output buffers
    captured at its expert FFN call."""
    seen = {}
    inner = jmoe._expert_ffn_vmapped

    def tap(gw, uw, dw, buffers, pol):
        out = inner(gw, uw, dw, buffers, pol)
        seen["buffers"], seen["out_buffers"] = buffers, out
        return out

    jmoe._expert_ffn_vmapped = tap
    try:
        out, aux = jmoe.moe_apply(p, jnp.asarray(x), policy, n_experts=E,
                                  experts_per_token=K, capacity_factor=cf)
    finally:
        jmoe._expert_ffn_vmapped = inner
    return (np.asarray(out), float(aux), np.asarray(seen["buffers"]),
            np.asarray(seen["out_buffers"]))


def _port_moe(m, x, cf, policy):
    """The port's ``moe_apply`` with its routing, dispatched buffers and
    expert outputs captured."""
    seen = {"calls": []}
    inner_route, inner_gemm = moe.route, moe.mirage_matmul_auto

    def tap_route(router, xf, k, C):
        seen["routing"] = inner_route(router, xf, k, C)
        return seen["routing"]

    def tap_gemm(a, w, pol):
        out = inner_gemm(a, w, pol)
        seen["calls"].append((a, out))
        return out

    moe.route, moe.mirage_matmul_auto = tap_route, tap_gemm
    try:
        with torch.no_grad():
            out, aux = moe.moe_apply(m, torch.from_numpy(x), policy,
                                     n_experts=E, experts_per_token=K,
                                     capacity_factor=cf)
    finally:
        moe.route, moe.mirage_matmul_auto = inner_route, inner_gemm
    return out, aux, seen


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_moe_apply_matches_jax(layer, cf, policy):
    p, m = layer
    x = _rand((3, 11, D), seed=5)
    T = x.shape[0] * x.shape[1]
    C = moe.capacity(T, E, K, cf)
    assert C == max(4, int(cf * T * K / E))
    want_out, want_aux, want_buf, want_obuf = _jax_moe(p, x, cf,
                                                       jpolicy(policy))
    got_out, got_aux, seen = _port_moe(m, x, cf, get_policy(policy))
    ids, positions, keep = _jax_routing(p, x.reshape(T, D), C)
    r = seen["routing"]
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.positions.numpy(), positions)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf == 1.25:
        assert not keep.all(), "the published capacity factor drops pairs"
    else:
        assert keep.all(), "the reduced configs' factor is dropless"
    buffers = seen["calls"][0][0].numpy()        # the gate GEMM's input
    out_buffers = seen["calls"][2][1].numpy()    # the down GEMM's output
    np.testing.assert_array_equal(buffers.view(np.int32),
                                  want_buf.view(np.int32))
    if policy == "mirage":
        # BFP products are exact, and each expert's product is the plain
        # 2-D GEMM's, as in JAX's vmap: the same bits
        np.testing.assert_array_equal(out_buffers.view(np.int32),
                                      want_obuf.view(np.int32))
    else:   # a batched f32 matmul sums in its own order
        np.testing.assert_allclose(out_buffers, want_obuf, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_aux), want_aux, rtol=1e-5)


def test_routing_ties_take_the_lower_expert(layer):
    """Equal probabilities: the top K come in expert order, as
    ``jax.lax.top_k`` orders them (a stable descending sort)."""
    _, m = layer
    router = moe.MoE(D, E, F, generator=torch.Generator().manual_seed(1),
                     device=torch.device("cpu")).router
    with torch.no_grad():
        router.w.zero_()                          # every expert ties
    r = moe.route(router, torch.ones((5, D)), 3, 8)
    assert r.expert_ids.tolist() == [[0, 1, 2]] * 5
    want = jax.lax.top_k(jnp.full((5, E), 1.0 / E), 3)[1]
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(want))


@pytest.mark.parametrize("scope", ["no_grad", "health", "grad"])
@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_batched_gemm_equals_jax_vmap_bitwise(policy, scope):
    """``mirage_matmul_auto`` with an (E, K, N) weight: JAX's vmap of its
    GEMM over the experts, bit for bit, with grad off, under an open
    analog-health scope, and through the autograd op's forward."""
    x, w = _rand((E, 6, 70), 1), _rand((E, 70, 20), 2, 0.1)
    jpol = jpolicy(policy)
    want = np.asarray(jax.vmap(lambda a, b: jgemm.mirage_matmul_auto(
        a, b, jpol))(jnp.asarray(x), jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if scope == "no_grad":
        with torch.no_grad():
            got = gemm.mirage_matmul_auto(xt, wt, get_policy(policy))
    elif scope == "health":
        with obs_health.collect():
            got = gemm.mirage_matmul_auto(xt, wt, get_policy(policy))
    else:
        got = gemm.mirage_matmul_auto(xt, wt.requires_grad_(),
                                      get_policy(policy)).detach()
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("dead", ["some", "all"])
@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_plain_stack_with_empty_experts_equals_jax_vmap(dead, rounding):
    """Experts whose x rows are all zero (the buffers of experts no token
    routed to, and their ``down`` inputs, silu(0) x 0): the plain version of
    the stack equals JAX's vmap of its GEMM bit for bit, and their rows are
    exactly +0.0 on both sides, the bits the stream route writes for an
    expert it skips."""
    x, w = _rand((8, 6, 70), 1), _rand((8, 70, 20), 2, 0.1)
    zero = [1, 2, 5, 6, 7] if dead == "some" else list(range(8))
    x[zero] = 0.0
    if dead == "some":
        x[3, :, :40] = 0.0       # a live expert with a zero K range
    jpol = jpolicy("mirage").replace(rounding=rounding)
    pol = get_policy("mirage").replace(rounding=rounding)
    want = np.asarray(jax.vmap(lambda a, b: jgemm.mirage_matmul_auto(
        a, b, jpol))(jnp.asarray(x), jnp.asarray(w)))
    with torch.no_grad():
        got = gemm.mirage_matmul_auto(torch.from_numpy(x),
                                      torch.from_numpy(w), pol).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[zero].view(np.int32).any()
    assert not want[zero].view(np.int32).any()
    if dead == "some":
        assert got[[0, 3, 4]].any()


@pytest.mark.parametrize("mode", ["mirage_rns", "mirage_rrns",
                                  "mirage_faithful", "mirage_faithful_ref",
                                  "int8"])
def test_two_d_backends_take_expert_stacks(mode):
    """The GEMM modes that take one (K, N) weight run a stack in one call,
    each expert's product the 2-D GEMM's, bit for bit (JAX's vmap of each
    is held in ``tests/test_torch_moe_rns.py``)."""
    assert backends.resolve(get_policy(mode)).supports_batched_weights
    x = torch.from_numpy(_rand((E, 4, 40), 11))
    w = torch.from_numpy(_rand((E, 40, 9), 12, 0.2))
    with torch.no_grad():
        got = gemm.mirage_matmul_nograd(x, w, get_policy(mode))
        for e in range(E):
            one = gemm.mirage_matmul_nograd(x[e], w[e], get_policy(mode))
            assert torch.equal(got[e].view(torch.int32),
                               one.view(torch.int32)), e


def test_fused_wrapper_stacks_on_the_cpu():
    """The kernel wrapper's CPU route (its plain version) over a stack in
    either weight layout equals the unbatched plain version per expert."""
    x = torch.from_numpy(_rand((3, 5, 40), 7))
    w_nk = torch.from_numpy(_rand((3, 9, 40), 8))     # (E, N, K)
    policy = get_policy("mirage")
    for w in (w_nk.transpose(1, 2), w_nk.transpose(1, 2).contiguous()):
        got = ops.mirage_matmul_fused(x, w, policy)
        want = torch.stack([ref.mirage_gemm_ref(x[e], w[e])
                            for e in range(3)])
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="same E"):
        ops.mirage_matmul_fused(x[:2], w_nk.transpose(1, 2), policy)


def test_gemm_plan_counts_the_stack_in_its_tiles():
    """E experts fill the card: at qwen3-moe's decode shapes the stack takes
    the stream route with no split of K, its persistent grid sized by the
    units of the whole stack (128 experts x 128-column tiles: one a block
    at gate/up, from a counter at down), where one expert alone splits K
    on the decode route; E = 1 is the unbatched plan.
    An (E, N, K) stack keeps the decode route, whose grid holds one wave of
    the blocks its shared memory lets reside."""
    for K, N in ((2048, 768), (768, 2048)):
        one = ops.gemm_plan(4, N, K, 4)
        assert ops.gemm_plan(4, N, K, 4, E=1) == one
        assert one.splits > 1 and one.route == "decode"
        stack = ops.gemm_plan(4, N, K, 4, E=128)
        assert stack.route == "stream" and stack.splits == 1
        assert stack.threads == ops.STREAM_THREADS
        per_sm = min(ops.STREAM_MAX_BLOCKS_PER_SM, ops.SM_SHARED_BYTES // (
            ops.stream_smem_bytes(4, 16, stack.stages, 128) +
            ops.BLOCK_RESERVED_SHARED_BYTES))
        assert stack.blocks == min(128 * N // ops.STREAM_COLS,
                                   per_sm * ops.H100_SMS)
        assert stack.stages == (ops.STREAM_STAGES_STATIC if K == 2048
                                else ops.STREAM_STAGES_DYNAMIC)
        nk = ops.gemm_plan(4, N, K, 4, E=128, w_nk=True)
        assert nk.route == "decode" and nk.splits == 1 and nk.threads == 128
        # one wave: 64 KB of shared memory a block at K = 2048 (3 an SM)
        per_sm = ops.decode_blocks_per_sm(4, 128, nk.k_split, 128)
        assert per_sm == (3 if K == 2048 else 4)
        assert nk.blocks == per_sm * 128 <= per_sm * ops.H100_SMS
    assert ops.gemm_plan(40, 768, 2048, 4, E=128).mma


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    cfg = jconfig(arch).reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch).reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return arch, jm, params, tm


def test_lm_forward_and_loss_match_jax(pair):
    """The whole reduced MoE LM: logits, the summed router aux loss and
    ``LM.loss`` (ce + router_aux_loss x aux / n_layers)."""
    arch, jm, params, tm = pair
    toks = np.random.default_rng(0).integers(0, 256, (2, 19)).astype(
        np.int32)
    labels = np.random.default_rng(1).integers(0, 256, (2, 19)).astype(
        np.int32)
    want, want_aux, _ = jm.forward(params, jnp.asarray(toks))
    want_loss, want_m = jm.loss(params, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
        _, got_aux, _ = tm.forward_hidden(torch.from_numpy(toks))
        got_loss, got_m = tm.loss({"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert float(got_aux) > 0
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["aux"]), float(want_m["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


def test_load_jax_params_covers_every_moe_leaf(pair):
    """Every leaf of the JAX MoE tree has a port parameter (the stacked
    ``layers.moe.{router.w, gate, up, down}`` included), and a tree
    missing one does not load."""
    arch, jm, params, tm = pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert set(tree["layers"]["moe"]) == {"router", "gate", "up", "down"}
    assert torch.equal(tm.layers[1].moe.down,
                       torch.from_numpy(tree["layers"]["moe"]["down"][1]))
    short = dict(tree, layers=dict(tree["layers"], moe={
        k: v for k, v in tree["layers"]["moe"].items() if k != "gate"}))
    with pytest.raises(ValueError, match="does not cover"):
        load_jax_params(tm, short)


@pytest.mark.parametrize("mode", ["mirage_rns", "mirage_rrns"])
def test_moe_under_rns_policies_builds_programs_and_switches(pair, mode):
    """MoE under the RNS family: the model builds; programming its
    stationary weights covers every Dense weight but the router and each
    layer's three expert stacks; an engine switched to the policy (per-call
    encoding, the JAX rule for MoE) and back drains the streams of fresh
    engines under each policy. The JAX engine's streams are held in
    ``tests/test_torch_server_moe_rrns.py``."""
    from repro_torch.runtime.server import LMServer, Request

    arch, jm, params, tm = pair
    cfg = get_config(arch).reduced()
    assert build_model(cfg, get_policy(mode), device="cpu").policy.mode == \
        mode
    enc = stationary.encode_stationary_params(tm, get_policy(mode))
    stacks = {k for k in enc if k.rsplit(".", 1)[-1] in
              stationary.MOE_STACKS}
    assert len(stacks) == 3 * cfg.n_layers
    assert not any(k.endswith("router") for k in enc)
    assert enc["layers.0.moe.gate"].residues.shape[:2] == \
        (len(stationary.stationary_moduli(get_policy(mode))), E)

    def drain(server):
        rng = np.random.default_rng(4)
        for i in range(2):
            server.submit(Request(rid=i, prompt=rng.integers(
                0, 256, 5).astype(np.int32), max_tokens=3))
        return {r.rid: r.tokens_out for r in server.run_until_drained()}

    fast = drain(LMServer(tm, cap=20, batch_slots=2))
    server = LMServer(tm, cap=20, batch_slots=2)
    server.switch_backend(get_policy(mode))
    assert not server.stationary_weights
    switched = drain(server)
    server.switch_backend(get_policy("mirage"))
    assert tm.policy.mode == "mirage_fast"
    assert drain(server) == fast
    tm.policy = get_policy(mode)
    try:
        fresh = LMServer(tm, cap=20, batch_slots=2)
        assert not fresh.stationary_weights
        assert drain(fresh) == switched
    finally:
        tm.policy = get_policy("mirage")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [0.0, 0.75])
@pytest.mark.parametrize("shape", [(128, 4, 2048, 768), (8, 160, 512, 300),
                                   (3, 5, 200, 77), (8, 4, 14336, 4096)])
def test_cuda_batched_gemm_equals_per_expert_launches(cuda, shape, empty):
    """One launch over the stack equals E single-expert launches of the
    route and split its plan picked, bit for bit, in both weight layouts;
    experts whose x rows are all zero (``empty`` of them) give rows of
    exactly +0.0."""
    En, M, Kd, N = shape
    policy = get_policy("mirage")
    x = torch.from_numpy(_rand((En, M, Kd), 1)).to(cuda)
    dead = torch.arange(En, device=cuda) < round(empty * En)
    x[dead] = 0.0
    for w in (torch.from_numpy(_rand((En, Kd, N), 2, 0.05)).to(cuda),
              torch.from_numpy(_rand((En, N, Kd), 3, 0.05)).to(cuda)
              .transpose(1, 2)):
        got = ops.mirage_matmul_fused(x, w, policy)
        w_nk = not w.is_contiguous()
        wk = w.transpose(1, 2) if w_nk else w
        plan = ops.gemm_plan(M, N, Kd, 4, ops.sm_count(cuda), True, En,
                             w_nk, wk.data_ptr() % 16 == 0)
        assert plan.route == ("stream" if M <= 16 and N % 4 == 0 and
                              not w_nk else "mma" if M > 16 else "decode")
        for e in range(En):
            one = torch.empty((1, M, N), device=cuda)
            ops.launch_gemm_plan(x[e:e + 1], wk[e:e + 1], one, plan, policy,
                                 w_nk)
            assert torch.equal(got[e].view(torch.int32),
                               one[0].view(torch.int32))
        assert not got[dead].view(torch.int32).any()
