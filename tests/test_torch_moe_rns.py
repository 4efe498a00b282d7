"""PyTorch port: the MoE family under the paper's RNS/RRNS datapath, against
the JAX package.

Every GEMM mode over an expert stack (``x (E, C, K)``, ``w (E, K, N)``):
the port's one call over the stack equals ``jax.vmap`` of the JAX GEMM
over the experts bit for bit, and the health counters equal the JAX
package's lifted sums. The JAX draws reach the port by stage name (as
``Replay`` of ``tests/test_torch_rns.py`` hands them over, drawn here in
the GEMM's own compile): under the vmap the key is not batched, so
every expert takes the same channel draws, and the port draws once at one
expert's shape. The CPU regimes are decided on one expert's sizes. The
stationary encoding of a stack draws its drift per expert, as the JAX
package splits its key.

Then one ``mirage_rns`` training step of a reduced MoE config (8
experts, top-2, d_model 64): its loss and gradients against
``jax.value_and_grad`` of the JAX loss. The engines that serve the reduced
MoE configs under ``mirage_rrns`` are held against the JAX engine in
``tests/test_torch_server_moe_rrns.py``. The residue kernels at the
full-width stack shapes run on the card (``cuda`` marker,
``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core import gemm as jgemm
from repro.core.backends import grouped as jgrouped
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.obs import health as jhealth
from repro_torch.analog import channel, rrns
from repro_torch.configs import get_config
from repro_torch.core import gemm, stationary
from repro_torch.core.backends import grouped
from repro_torch.core.backends import mirage_rns as tmirage_rns
from repro_torch.core.precision import get_policy
from repro_torch.interop import _by_name, _jax_layout
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import health

E = 8


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class Stored:
    """Draws that hand out arrays the JAX package drew, by stage name."""

    def __init__(self, arrays):
        self.arrays = arrays

    def normal(self, stage, shape):
        a = self.arrays[stage]
        assert a.shape == tuple(shape), (stage, a.shape, shape)
        return torch.from_numpy(np.array(a))

    uniform = normal

    def randint(self, stage, shape, low, high):
        return self.normal(stage, shape)


def _stage_draws(mode, kw, key, K, M, N):
    """The JAX draws of one expert-shaped GEMM call that the port asks
    for, by its stage names (the key splits of ``mirage_rrns.py:132-136``
    and ``channel.py:268-277``), traced beside the GEMM so that one
    compile covers both."""
    p = get_policy(mode, **kw)
    G = -(-K // p.g)
    if mode in ("mirage_rns", "mirage_rns_pallas"):
        return {"detector": jax.random.normal(key, (3, G, M, N))} \
            if p.noise_sigma > 0 else {}
    if "rns" not in mode:
        return {}
    moduli = rrns.rrns_moduli(p) if "rrns" in mode else tuple(p.moduli)
    n = len(moduli)
    cfg = channel.AnalogChannelConfig.from_policy(p)
    k_prog, k_det, k_burst = jax.random.split(key, 3)
    out = {}
    if cfg.phase_drift_sigma > 0:
        out["drift"] = jax.random.normal(k_prog, (n, G, p.g, N))
    if any(s > 0 for s in cfg.detector_sigmas(moduli)):
        out["detector"] = jax.random.normal(k_det, (n, G, M, N))
    if cfg.burst_rate > 0:
        k_hit, k_pos, k_err = jax.random.split(k_burst, 3)
        out["burst_hit"] = jax.random.uniform(k_hit, (G, M, N))
        out["burst_pos"] = jax.random.randint(k_pos, (G, M, N), 0, n)
        for i, m in enumerate(moduli):
            out[f"burst_err/{i}"] = jax.random.randint(
                jax.random.fold_in(k_err, i), (G, M, N), 1, m)
    return out


def _jax_vmap(mode, kw, x, w, key):
    """``jax.vmap`` of the JAX GEMM over the experts, one unbatched key for
    all of them, with each expert's health records lifted out of the vmap
    and summed (``repro.models.moe._expert_ffn_vmapped``'s lift), and the
    call's draws for the port (:class:`Stored`)."""
    jp = jpolicy(mode, **kw)
    if mode == "mirage_rns_pallas":
        jp = jp.replace(interpret=True)

    def one(a, b):
        with jhealth.collect() as hc:
            out = jgemm.mirage_matmul_nograd(a, b, jp, key=key)
        return out, dict(hc.values)

    def run(a, b):
        out, h = jax.vmap(one)(a, b)
        draws = {} if key is None else _stage_draws(
            mode, kw, key, a.shape[-1], a.shape[-2], b.shape[-1])
        return out, h, draws

    # jitted, but for int8, whose division by a traced scale XLA's fusion
    # rounds otherwise than its eager op does
    out, h, draws = (run if mode == "int8" else jax.jit(run))(
        jnp.asarray(x), jnp.asarray(w))
    return (np.asarray(out),
            {k: np.asarray(jnp.sum(v, axis=0)) for k, v in h.items()},
            Stored({k: np.asarray(v) for k, v in draws.items()}))


#: (mode, policy fields, K) of the stack checks: every 2-D GEMM mode, the
#: analog stages one by one, and the blocked CPU regime
STACK_CASES = [
    ("mirage_rns", {}, 70),
    ("mirage_rns", dict(noise_sigma=0.4), 48),
    ("mirage_rns", dict(group_block=2), 48),
    ("mirage_rns_pallas", {}, 48),
    ("mirage_rns_noisy", dict(snr_db=26.0, adc_bits=4, dac_bits=4,
                              crosstalk=0.05, phase_drift_sigma=0.3), 48),
    ("mirage_rrns", {}, 48),
    ("mirage_rrns", dict(snr_db=30.0, burst_rate=0.02, burst_width=1,
                         adc_bits=5), 48),
    ("mirage_rrns_ref", dict(snr_db=22.0), 48),
    ("mirage_faithful", {}, 70),
    ("mirage_faithful_ref", {}, 48),
    ("mirage_rns_ref", {}, 48),
    ("int8", {}, 70),
]


@pytest.mark.parametrize("mode,kw,K", STACK_CASES)
def test_stack_gemm_equals_jax_vmap(mode, kw, K):
    """One call over the stack: JAX's vmap of its GEMM, bit for bit, with
    equal health counters (sums over the experts)."""
    x, w = _rand((E, 5, K), 21), _rand((E, K, 11), 22, 0.2)
    key = jax.random.PRNGKey(23)
    want, jvals, draws = _jax_vmap(mode, kw, x, w, key)
    with health.collect() as hc:
        with torch.no_grad():
            got = gemm.mirage_matmul_nograd(
                _t(x), _t(w), get_policy(mode, **kw), draws=draws).numpy()
    assert got.shape == want.shape == (E, 5, 11)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert hc.values.keys() == jvals.keys()
    for name, v in hc.values.items():
        np.testing.assert_array_equal(v.numpy(), jvals[name])
    if "rrns" in mode and kw:
        assert int(hc.values["rrns_corrected"]) > 0


@pytest.mark.parametrize("budget", ["one_expert_fits", "none_fits"])
def test_cpu_regime_is_decided_per_expert(monkeypatch, budget):
    """The vectorize budget is weighed against one expert's residues, as
    under the JAX vmap: between one expert's and the stack's size both
    packages take one batched product; below one expert's both walk
    blocks of groups (20 groups: the block order shows in the f32 sum)."""
    K, M, N, nm = 320, 6, 9, 3
    one = nm * (K // 16) * M * N * 4
    limit = 2 * one if budget == "one_expert_fits" else one // 2
    assert limit < E * one
    monkeypatch.setattr(grouped, "VECTORIZE_BUDGET_BYTES", limit)
    monkeypatch.setattr(jgrouped, "VECTORIZE_BUDGET_BYTES", limit)
    x, w = _rand((E, M, K), 31, 4.0), _rand((E, K, N), 32, 0.3)
    want, _, _ = _jax_vmap("mirage_rns", {}, x, w, None)
    with torch.no_grad():
        got = gemm.mirage_matmul_nograd(_t(x), _t(w),
                                        get_policy("mirage_rns")).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mode,kw", [
    ("mirage_rns_noisy", dict(snr_db=10.0, phase_drift_sigma=0.4)),
    ("mirage_rrns", dict(snr_db=20.0, burst_rate=0.05)),
])
def test_channel_noise_is_shared_across_experts(mode, kw):
    """Identical experts give identical noisy outputs, far from the clean
    channel's (the JAX vmap draws once, as ``test_stack_gemm_equals_jax_
    vmap`` holds bit for bit); with a noise seed and no draws each
    expert's output is the 2-D GEMM's at the same seed, whose
    ``_dims_tag`` folds one expert's shapes; the health counters are the
    2-D GEMM's times E."""
    x1, w1 = _rand((5, 48), 41), _rand((48, 11), 42, 0.2)
    x, w = _t(np.stack([x1] * E)), _t(np.stack([w1] * E))
    p = get_policy(mode, noise_seed=3, **kw)
    with torch.no_grad():
        with health.collect() as hs:
            got = gemm.mirage_matmul_nograd(x, w, p)
        with health.collect() as h1:
            solo = gemm.mirage_matmul_nograd(_t(x1), _t(w1), p)
        clean = gemm.mirage_matmul_nograd(_t(x1), _t(w1),
                                          get_policy(mode))
    for e in range(E):
        assert torch.equal(got[e], solo)
    assert float(torch.abs(solo - clean).max()) > 1.0
    assert hs.values.keys() == h1.values.keys()
    for name, v in h1.values.items():
        assert torch.equal(hs.values[name], E * v), name
        assert int(v.sum()) > 0, name


def test_stationary_drift_is_drawn_per_expert():
    """A stack's stationary residues draw their drift per expert, in the
    JAX package's order (``encode_stationary`` splits the key per expert;
    a sequence of draws here is that split, each expert's the 2-D
    encoding's with its own draws, which ``tests/test_torch_rns.py`` holds
    against the JAX encoding bit for bit): identical experts are
    programmed with different drift. One draws object serves the experts
    in turn; a drift-free stack is encoded in one pass."""
    kw = dict(phase_drift_sigma=0.6, dac_bits=5, noise_seed=11)
    p = get_policy("mirage_rrns", **kw)
    w1 = _rand((48, 11), 51, 0.2)
    w = _t(np.stack([w1] * E))
    gens = [torch.Generator().manual_seed(60 + e) for e in range(E)]
    got = stationary.encode_stationary(
        w, p, draws=[channel.GeneratorDraws(g) for g in gens])
    assert got.n_experts == E and got.residues.shape[:2] == (5, E)
    for e in range(E):
        one = stationary.encode_stationary(
            w[e], p, draws=channel.GeneratorDraws(
                torch.Generator().manual_seed(60 + e)))
        assert torch.equal(got[e].residues, one.residues)
        assert torch.equal(got[e].scale, one.scale)
    assert not torch.equal(got.residues[:, 0], got.residues[:, 1])
    turn = stationary.encode_stationary(w, p, draws=channel.GeneratorDraws(
        torch.Generator().manual_seed(7)))
    assert not torch.equal(turn.residues[:, 0], turn.residues[:, 1])
    clean = get_policy("mirage_rrns", dac_bits=5)
    whole = stationary.encode_stationary(w, clean)
    assert torch.equal(whole[3].residues,
                       stationary.encode_stationary(w[3], clean).residues)


def test_channel_kernel_plain_version_reads_noise_by_group_period():
    """The fused readout's plain version over (n_mod, E x G) slots with a
    (n_mod, G, M, N) noise equals it with the noise repeated E times, and
    refuses a period that does not divide the slots."""
    moduli = (31, 32, 33, 37, 41)
    gen = torch.Generator().manual_seed(0)
    G, M, g, N = 3, 4, 16, 9
    xr = torch.stack([torch.randint(0, m, (E * G, M, g), generator=gen,
                                    dtype=torch.int32) for m in moduli])
    wr = torch.stack([torch.randint(0, m, (E * G, g, N), generator=gen,
                                    dtype=torch.int32) for m in moduli])
    noise = torch.randn((5, G, M, N), generator=gen) * 2.0
    got, flips = ops.rns_group_matmul_channel(xr, wr, moduli, noise,
                                              adc_bits=4, count_flips=True)
    want, wflips = ref.rns_matmul_channel_ref(
        xr, wr, moduli, noise.repeat(1, E, 1, 1), 4, count_flips=True)
    assert torch.equal(got, want) and torch.equal(flips, wflips)
    assert int(flips.sum()) > 0
    with pytest.raises(ValueError, match="period"):
        ref.rns_matmul_channel_ref(xr, wr, moduli, noise[:, :1].repeat(
            1, 5, 1, 1), count_flips=False)


def test_card_block_plan_at_the_stack_shapes():
    """Whole experts per launch while one expert's residues fit the
    budget (qwen3-moe's gate/up stack under RRNS at decode: one launch of
    5 x 128 x 128 = 81,920 slots), else one expert in blocks of groups
    (mixtral's prefill gate/up: 11.7 GB an expert)."""
    plan = tmirage_rns.card_blocks
    assert plan(5, 128, 128, 4, 768) == (128, 128)
    # qwen3-moe's down stack at a 40-row prefill: 78.6 MB an expert
    assert plan(5, 128, 48, 40, 2048) == (27, 48)
    eb, gb = plan(5, 8, 256, 160, 14336)
    assert eb == 1 and gb == tmirage_rns.card_group_block(5, 256, 160, 14336)
    assert 5 * gb * 160 * 14336 * 4 <= tmirage_rns.CARD_RESIDUE_BUDGET_BYTES
    assert plan(5, 8, 896, 4, 4096) == (7, 896)
    assert plan(3, 1, 56, 4, 151936) == (1, 56)


# --------------------------------------------------------------------------
# one mirage_rns training step
# --------------------------------------------------------------------------

def test_mirage_rns_training_step_matches_jax():
    """``LM.loss`` and every gradient under ``mirage_rns`` (each expert
    stack's forward, dX and dW one call over the stack) against
    ``jax.value_and_grad`` of the JAX loss, one layer of qwen3-moe: the
    loss within 1e-6 relative, each gradient leaf within 1e-5 of its
    largest element (only the f32 order of the cross-group sums differs
    in the GEMMs; the loss and the gradients sum them in other orders)."""
    arch = "qwen3-moe-30b-a3b"
    cut = dict(n_layers=1, capacity_factor=1.25)
    jcfg = dataclasses.replace(jconfig(arch).reduced(), **cut)
    tm = build_model(dataclasses.replace(get_config(arch).reduced(), **cut),
                     get_policy("mirage_rns"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    params = _jax_layout(tm, dict(tm.named_parameters()),
                         lambda t: t.detach().numpy().copy(), np.stack)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 24)).astype(np.int32)}
    jm = jbuild(jcfg, jpolicy("mirage_rns"), JOptions(q_chunk=16,
                                                      kv_chunk=16))
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    loss, _ = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [p for _, p in tm.named_parameters()])))
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    assert set(grads) == set(want)
    for n, g in grads.items():
        gap = float(np.abs(g.numpy() - want[n]).max())
        assert gap <= 1e-5 * float(np.abs(want[n]).max()) + 1e-12, n


# --------------------------------------------------------------------------
# on the card: the residue kernels at the full-width stack shapes
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E_,G,M,N", [(128, 128, 4, 768), (8, 16, 40, 300),
                                      (3, 5, 17, 130)])
def test_cuda_residue_kernels_over_stack_slots(cuda, E_, G, M, N):
    """Kernels 4 and 5 over (n_mod, E x G) slots, 81,920 of them at
    qwen3-moe's gate/up decode stack, with noise of group period G: equal
    to their plain versions; a block of whole experts sliced in place
    from the stack equals its rows of the whole launch."""
    moduli = (31, 32, 33, 37, 41)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xr = torch.stack([torch.randint(0, m, (E_ * G, M, 16), generator=gen,
                                    device=cuda, dtype=torch.int32)
                      for m in moduli])
    wr = torch.stack([torch.randint(0, m, (E_ * G, 16, N), generator=gen,
                                    device=cuda, dtype=torch.int32)
                      for m in moduli])
    noise = torch.randn((5, G, M, N), generator=gen, device=cuda)
    got = ops.rns_group_matmul(xr, wr, moduli)
    assert torch.equal(got, ref.rns_matmul_ref(xr, wr, moduli))
    res, flips = ops.rns_group_matmul_channel(xr, wr, moduli, noise, 4,
                                              count_flips=True)
    want, wflips = ref.rns_matmul_channel_ref(xr, wr, moduli, noise, 4,
                                              count_flips=True)
    assert torch.equal(res, want) and torch.equal(flips, wflips)
    half = (E_ + 1) // 2 * G
    part = ops.rns_group_matmul(xr[:, :half], wr[:, :half], moduli)
    assert torch.equal(part, got[:, :half])
