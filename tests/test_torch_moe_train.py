"""PyTorch port: MoE training against the JAX package.

The reduced MoE configs (8 experts, top-2, d_model 64, moe_d_ff 32) cut to
2 layers, at the published capacity factor 1.25, where (token, slot) pairs
overflow their expert's buffer and drop. The same numpy-seeded inputs go
through both packages, and the weights are the port's, drawn from a seed
and handed to the JAX package in its own layout (layer leaves stacked on
axis 0):

- the batched GEMM's backward (``MirageMatmul`` with an ``(E, K, N)``
  weight: dX over N and dW over the C buffer rows, one call a stack)
  against ``jax.vjp`` of ``jax.vmap(repro.core.gemm.mirage_matmul)`` at
  rtol = atol = 1e-6, in both weight layouts the trainer hands it;
- ``LM.loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the JAX ``loss`` under mirage (each leaf within 1e-4 of its largest
  element), plain and under ``ce_chunk`` + ``remat``;
- three train steps against the JAX ``train_step`` (rtol 1e-5 under
  ``fp32``, 1e-3 under ``mirage``), also with weight-stationary
  quantization and BFP gradient compression;
- a MoE train-state checkpoint that either package restores, a resume
  bit for bit, and ``launch.train --arch qwen3-moe-30b-a3b --layers 2``.

JAX compiles are shared through module-scoped fixtures. The kernel at the
full-width backward stacks runs on the card (``tests/test_torch_gemm_stack
.py``'s ``cuda``-marked tests and ``chip_smoke.py``).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten as jflatten
from repro.configs import get_config as jconfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import gemm as jgemm
from repro.core.precision import get_policy as jpolicy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import SyntheticLMConfig as JSyntheticLMConfig
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.optim import grad_compress as jgrad_compress
from repro.runtime import trainer as jtrainer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import gemm
from repro_torch.core.precision import get_policy
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import (_by_name, _jax_layout, load_jax_params,
                                 restore_train_state, to_jax_train_state)
from repro_torch.kernels import ref
from repro_torch.models import build_model, moe
from repro_torch.models.lm import LMCallOptions
from repro_torch.optim import grad_compress
from repro_torch.runtime import trainer

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
E, D, F = 8, 64, 40
CF, LAYERS, SEQ, BATCH = 1.25, 2, 32, 2


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _cfgs(arch):
    """(JAX config, port config): reduced, 2 layers, capacity factor 1.25."""
    cut = dict(n_layers=LAYERS, capacity_factor=CF)
    return (dataclasses.replace(jconfig(arch).reduced(), **cut),
            dataclasses.replace(get_config(arch).reduced(), **cut))


def _port(arch, policy, seed=0, **opts):
    """The port's reduced model, weights drawn from ``seed``."""
    return build_model(_cfgs(arch)[1], policy,
                       LMCallOptions(q_chunk=16, kv_chunk=16, **opts),
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _jax_tree(tm, tree):
    """A name-keyed tree of ``tm``'s (its params, or moments) in the JAX
    package's layout: layer leaves stacked on axis 0, numpy leaves."""
    return _jax_layout(tm, tree, lambda t: t.detach().numpy().copy(),
                       np.stack)


def _batch(step=0):
    return JSyntheticLM(JSyntheticLMConfig(
        vocab_size=256, seq_len=SEQ, batch_size=BATCH)).batch_at(step)


def test_the_reduced_batch_drops_pairs():
    """At capacity factor 1.25 the test batch overflows some expert's
    buffer in both configs (the backward's dropped rows are exercised)."""
    for arch in ARCHS:
        tm = _port(arch, get_policy("fp32"))
        cfg = tm.cfg
        T = SEQ * BATCH
        C = moe.capacity(T, cfg.n_experts, cfg.experts_per_token, CF)
        with torch.no_grad():
            h = tm.embed.emb[torch.from_numpy(_batch()["tokens"]).long()]
            r = moe.route(tm.layers[0].moe.router, h.reshape(T, -1),
                          cfg.experts_per_token, C)
        assert int((~r.keep).sum()) > 0, arch


# --------------------------------------------------------------------------
# the batched GEMM's backward against jax.vjp of jax.vmap
# --------------------------------------------------------------------------

def _on_grid(w, b_m=4, g=16):
    """(E, K, N) on its BFP grid along K, per expert (what
    weight-stationary training feeds the GEMM)."""
    t = torch.from_numpy(w).transpose(1, 2)
    return ref.bfp_fake_quant_ref(t, b_m, g).transpose(1, 2).numpy().copy()


def _vjp_operands(aq, C):
    """(x, w, dO) of the batched GEMM check, w on its grid under ``aq``."""
    w = _rand((E, D, F), 2, 1 / np.sqrt(D))
    return _rand((E, C, D), 1), _on_grid(w) if aq else w, \
        _rand((E, C, F), 3, 0.1)


@functools.lru_cache(maxsize=None)
def _jax_vjp(mode, aq, C):
    """The forward and ``jax.vjp`` of ``jax.vmap(mirage_matmul)`` at
    ``_vjp_operands``: computed once for both weight layouts."""
    jp = jpolicy(mode, assume_quantized_weights=aq)

    @jax.jit
    def fwd_and_vjp(a, b, d):
        y, vjp = jax.vjp(
            jax.vmap(lambda a1, b1: jgemm.mirage_matmul(a1, b1, jp)), a, b)
        return (y,) + vjp(d)
    return fwd_and_vjp(*map(jnp.asarray, _vjp_operands(aq, C)))


@pytest.mark.parametrize("layout", ["EKN", "ENK"])
@pytest.mark.parametrize("C", [5, 20])
@pytest.mark.parametrize("mode,aq", [("fp32", False), ("mirage", False),
                                     ("mirage", True)])
def test_batched_function_matches_jax_vjp(mode, aq, C, layout):
    """dX (E, C, K) = dO @ W^T grouped along N, dW (E, K, N) = X^T @ dO
    grouped along C (5: one ragged group; 20: a full and a ragged one),
    each one call over the stack; ``ENK`` hands the weight over as the
    transposed view of a contiguous (E, N, K) stack, the layout of the
    trainer's weight-stationary copies. dO is gradient-sized (0.1), so
    that the 1e-6 absolute limit lies above the f32 summation-order noise
    of unit-sized 20-term sums (the two packages' matmuls add in other
    orders)."""
    x, w, dout = _vjp_operands(aq, C)
    want, jdx, jdw = _jax_vjp(mode, aq, C)
    tw = torch.from_numpy(w) if layout == "EKN" else \
        torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))) \
        .transpose(1, 2)
    tw.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    got = gemm.mirage_matmul(tx, tw, get_policy(
        mode, assume_quantized_weights=aq))
    got.backward(torch.from_numpy(dout))
    _close(got.detach(), want, 1e-6)
    _close(tx.grad, jdx, 1e-6)
    _close(tw.grad, jdw, 1e-6)
    assert tw.grad.shape == (E, D, F)


def test_batched_backward_is_one_call_a_stack(monkeypatch):
    """The forward, dX and dW of a stack each dispatch once (no loop over
    experts above the backend)."""
    calls = []
    inner = gemm._forward_impl

    def spy(x, w, policy, draws=None):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return inner(x, w, policy, draws)

    monkeypatch.setattr(gemm, "_forward_impl", spy)
    tx = torch.from_numpy(_rand((E, 7, D), 4)).requires_grad_()
    tw = torch.from_numpy(_rand((E, D, F), 5)).requires_grad_()
    gemm.mirage_matmul(tx, tw, get_policy("mirage")).sum().backward()
    assert calls == [((E, 7, D), (E, D, F)), ((E, 7, F), (E, F, D)),
                     ((E, D, 7), (E, 7, F))]


# --------------------------------------------------------------------------
# LM.loss and its gradients against jax.value_and_grad
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """Reduced MoE weights drawn by the port from seed 0, in the JAX
    package's parameter tree (both packages draw them alike; the JAX
    ``init`` would add its own compile to the file's time)."""
    tm = _port(arch, get_policy("fp32"))
    return _jax_tree(tm, dict(tm.named_parameters()))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, policy, opts=()):
    """``jax.value_and_grad`` of the JAX ``loss`` at ``_jax_params(arch)``
    on the test batch: (loss, aux, gradients by the port's names)."""
    jm = jbuild(_cfgs(arch)[0], jpolicy(policy),
                JOptions(q_chunk=16, kv_chunk=16, **dict(opts)))
    # jitted: one XLA compile instead of the eager op-by-op ones
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        _jax_params(arch), {k: jnp.asarray(v) for k, v in _batch().items()})
    return float(jl), float(jmet["aux"]), _by_name(
        _port(arch, get_policy("fp32")),
        jax.tree_util.tree_map(np.asarray, jg))


def _port_loss_and_grads(arch, policy, opts=()):
    """The port's loss, aux loss and gradients by name at the JAX
    package's weights on the test batch."""
    tm = _port(arch, get_policy(policy), **dict(opts))
    load_jax_params(tm, _jax_params(arch))
    loss, met = tm.loss({k: torch.from_numpy(v) for k, v in _batch().items()})
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return loss.detach(), met["aux"].detach(), dict(zip(names, grads))


def _leaf_gaps(got, want):
    """Each leaf's largest difference over its reference's largest
    element."""
    return {n: float(np.abs(np.asarray(got[n]) - want[n]).max()) /
            (float(np.abs(want[n]).max()) + 1e-30) for n in want}


def _assert_leaves_close(got, want):
    """Each leaf within 1e-4 of its reference's largest element (+ 1e-8)."""
    assert set(want) == set(got)
    for n, gap in _leaf_gaps(got, want).items():
        assert gap <= 1e-4 + 1e-8 / (float(np.abs(want[n]).max()) + 1e-30), n


#: (arch, LMCallOptions) of the loss and gradient checks under mirage:
#: both configs plain, and ce_chunk (a chunk that does not divide the 64
#: tokens) + remat
LOSS_CASES = [("mixtral-8x7b", ()), ("qwen3-moe-30b-a3b", ()),
              ("qwen3-moe-30b-a3b", (("ce_chunk", 24), ("remat", True)))]


@pytest.mark.parametrize("arch,opts", LOSS_CASES)
def test_loss_and_grads_match_jax(arch, opts):
    """Every leaf, the routers' f32 weights and the expert stacks
    included, against the JAX model under the same policy and options."""
    jl, jaux, want = _jax_loss_and_grads(arch, "mirage", opts)
    loss, aux, got = _port_loss_and_grads(arch, "mirage", opts)
    _close(loss, jl, 1e-5)
    _close(aux, jaux, 1e-5)
    _assert_leaves_close(got, want)
    stacks = [n for n in got if n.endswith(("moe.gate", "moe.up",
                                            "moe.down"))]
    assert len(stacks) == 3 * LAYERS
    routers = [n for n in got if n.endswith("router.w")]
    assert routers and all(np.abs(want[n]).max() > 0 for n in routers)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_the_mirage_gradients(arch):
    """Under mirage the port's ``remat`` recomputes each layer's forward
    bit for bit: the loss and every gradient leaf equal the plain
    step's."""
    out = []
    for opts in ({}, {"remat": True}):
        tm = build_model(_cfgs(arch)[1], get_policy("mirage"),
                         LMCallOptions(q_chunk=16, kv_chunk=16, **opts),
                         device="cpu",
                         generator=torch.Generator().manual_seed(2))
        loss, _ = tm.loss({k: torch.from_numpy(v)
                           for k, v in _batch().items()})
        out.append([loss.detach()] + list(torch.autograd.grad(
            loss, list(tm.parameters()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# train steps, weight-stationary quantization and gradient compression
# --------------------------------------------------------------------------

def _train_both(arch, policy, steps, tc_kw=None, pol_kw=None):
    """``steps`` JAX train steps (jitted) and the port's from one initial
    state; returns the (JAX, port) step losses and grad norms, the
    JAX states after each step, and the port's model and state."""
    tc_kw, pol_kw = tc_kw or {}, pol_kw or {}
    jcfg = _cfgs(arch)[0]
    jp, tp = jpolicy(policy, **pol_kw), get_policy(policy, **pol_kw)
    jm = jbuild(jcfg, jp, JOptions(q_chunk=16, kv_chunk=16))
    jtc = JTrainConfig(policy=jp, optimizer="adamw", lr=1e-3, **tc_kw)
    tm = _port(arch, tp)
    ttc = TrainConfig(policy=tp, optimizer="adamw", lr=1e-3, **tc_kw)
    tstate = trainer.init_train_state(tm, ttc)
    # the JAX initial state is the port's, in the JAX layout
    jstate = to_jax_train_state(tm, tstate)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    tstep = trainer.make_train_step(tm, ttc)
    dcfg = dict(vocab_size=256, seq_len=SEQ, batch_size=BATCH)
    jdata = JSyntheticLM(JSyntheticLMConfig(**dcfg))
    tdata = SyntheticLM(SyntheticLMConfig(**dcfg))
    traj, jstates = [], []
    for _ in range(steps):
        jstate, jmet = jstep(jstate, next(jdata))
        tstate, tmet = tstep(tstate, next(tdata))
        jstates.append(jax.tree_util.tree_map(np.asarray, jstate))
        traj.append((float(jmet["loss"]), float(tmet["loss"]),
                     float(jmet["grad_norm"]), float(tmet["grad_norm"])))
    return {"traj": np.array(traj), "jstates": jstates, "tm": tm,
            "ttc": ttc, "tstate": tstate}


@pytest.fixture(scope="module")
def fp32_run():
    return _train_both("mixtral-8x7b", "fp32", 3)


def test_steps_match_jax_fp32(fp32_run):
    traj = fp32_run["traj"]
    np.testing.assert_allclose(traj[:, 1], traj[:, 0], rtol=1e-5)
    np.testing.assert_allclose(traj[:, 3], traj[:, 2], rtol=1e-5)


def test_steps_match_jax_mirage_wsq_bfp():
    """Under mirage with weight-stationary bf16 copies (the routers'
    weights among them, as in the JAX ``_QUANT_LEAF``), BFP gradient
    compression with error feedback over the 3-D expert leaves, and two
    microbatches."""
    run = _train_both(
        "qwen3-moe-30b-a3b", "mirage", 3,
        tc_kw=dict(weight_stationary_quant=True, microbatches=2,
                   quant_param_dtype="bfloat16", grad_compression="bfp"),
        pol_kw=dict(assume_quantized_weights=True))
    traj = run["traj"]
    np.testing.assert_allclose(traj[:, 1], traj[:, 0], rtol=1e-3)
    np.testing.assert_allclose(traj[:, 3], traj[:, 2], rtol=1e-3)
    err = run["tstate"]["err"]
    assert set(err) == set(run["tstate"]["params"])
    assert err["layers.0.moe.gate"].shape == (8, 64, 32)
    assert bool(err["layers.0.moe.down"].any())


def test_prequantize_matches_jax():
    """Weight-stationary quantization of a MoE tree: the expert stacks per
    expert along K, and the router's ``w`` too (a ``_QUANT_LEAF`` of rank
    2 in both packages)."""
    tm = _port("mixtral-8x7b", get_policy("mirage"), seed=1)
    params = _jax_tree(tm, dict(tm.named_parameters()))
    got = trainer._prequantize_params(dict(tm.named_parameters()),
                                      get_policy("mirage"), torch.bfloat16)
    jpre = jax.jit(lambda p: jtrainer._prequantize_params(
        p, jpolicy("mirage"), jnp.bfloat16))
    want = _by_name(tm, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jpre(params)))
    quantized = trainer._quantized_names(dict(tm.named_parameters()))
    assert "layers.0.moe.router.w" in quantized
    # q k v o, the router, gate up down, and the untied head
    assert len(quantized) == 8 * LAYERS + 1
    for n in quantized:
        assert got[n].dtype == torch.bfloat16 and got[n].requires_grad
        np.testing.assert_array_equal(got[n].detach().float().numpy(),
                                      want[n], err_msg=n)


def test_grad_compression_of_expert_stacks_matches_jax():
    """BFP compression with error feedback along the last axis of a 3-D
    leaf, as the JAX ``compress_with_error_feedback``."""
    g = {"s": _rand((E, D, F), 6, 1e-3), "b": _rand((F,), 7, 1e-3)}
    e = {"s": _rand((E, D, F), 8, 1e-5), "b": np.zeros((F,), np.float32)}
    jq, je = jax.jit(jgrad_compress.compress_with_error_feedback)(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()})
    tq, te = grad_compress.compress_with_error_feedback(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


# --------------------------------------------------------------------------
# checkpoints across the packages, resume, the launcher
# --------------------------------------------------------------------------

def test_port_resumes_a_jax_moe_checkpoint(tmp_path, fp32_run):
    """JAX's ``Checkpointer`` wrote the state after step 1 (expert stacks
    (n_layers, E, K, N)); the port restores it and its next two steps equal
    JAX's steps 2 and 3."""
    s1 = fp32_run["jstates"][0]
    JCheckpointer(str(tmp_path)).save(s1, step=1,
                                      metadata={"data": {"step": 1}})
    assert s1["params"]["layers"]["moe"]["gate"].shape == (LAYERS, 8, 64, 32)
    tm = _port("mixtral-8x7b", get_policy("fp32"))
    state = trainer.init_train_state(tm, fp32_run["ttc"])
    state, meta = restore_train_state(Checkpointer(str(tmp_path)), tm, state)
    assert meta == {"data": {"step": 1}} and int(state["step"]) == 1
    want = _by_name(tm, s1["opt"]["v"])
    for n, arr in want.items():
        np.testing.assert_array_equal(state["opt"]["v"][n].numpy(), arr)
    step = trainer.make_train_step(tm, fp32_run["ttc"])
    for i in (1, 2):
        state, met = step(state, _batch(i))
        np.testing.assert_allclose(float(met["loss"]),
                                   fp32_run["traj"][i, 0], rtol=1e-5)


def test_jax_restores_a_port_moe_checkpoint(tmp_path, fp32_run):
    """JAX's ``Checkpointer.restore`` reads the port's MoE checkpoint into
    a JAX template: the same leaf paths, dtypes and values, bit for bit."""
    tm, tstate = fp32_run["tm"], fp32_run["tstate"]
    Checkpointer(str(tmp_path)).save(to_jax_train_state(tm, tstate), step=3)
    template = fp32_run["jstates"][-1]
    restored, _ = JCheckpointer(str(tmp_path)).restore(template)
    jflat = jflatten(restored)
    want = jflatten(to_jax_train_state(tm, tstate))
    assert list(jflat) == list(jflatten(template)) == list(want)
    for path, arr in want.items():
        got = np.asarray(jflat[path])
        assert got.dtype == arr.dtype, path
        np.testing.assert_array_equal(got, arr, err_msg=path)
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["layers"]["moe"]["down"])[1],
        tstate["params"]["layers.1.moe.down"].detach().numpy())


def test_moe_resume_is_bit_for_bit(tmp_path):
    """Under mirage: 4 steps straight equal 2 steps, a checkpoint, a
    restore into a model of other weights and 2 more, every leaf of the
    state bit for bit (masters, moments, error buffer)."""
    pol = get_policy("mirage")
    tc = TrainConfig(policy=pol, lr=1e-3, grad_compression="bfp")
    dcfg = SyntheticLMConfig(vocab_size=256, seq_len=SEQ, batch_size=BATCH)

    def model(seed):
        return build_model(_cfgs("qwen3-moe-30b-a3b")[1], pol,
                           LMCallOptions(q_chunk=16, kv_chunk=16),
                           device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    ma = model(0)
    sa, step_a, data = trainer.init_train_state(ma, tc), \
        trainer.make_train_step(ma, tc), SyntheticLM(dcfg)
    for _ in range(4):
        sa, _ = step_a(sa, next(data))
    mb = model(0)
    sb, step_b, data = trainer.init_train_state(mb, tc), \
        trainer.make_train_step(mb, tc), SyntheticLM(dcfg)
    for _ in range(2):
        sb, _ = step_b(sb, next(data))
    ck = Checkpointer(str(tmp_path))
    ck.save(to_jax_train_state(mb, sb), step=2,
            metadata={"data": data.state()})
    mc = model(1)
    sc = trainer.init_train_state(mc, tc)
    sc, meta = restore_train_state(ck, mc, sc)
    data = SyntheticLM(dcfg)
    data.restore(meta["data"])
    step_c = trainer.make_train_step(mc, tc)
    for _ in range(2):
        sc, _ = step_c(sc, next(data))
    assert int(sa["step"]) == int(sc["step"]) == 4
    for key in ("params", "err"):
        for n in sa[key]:
            assert torch.equal(sa[key][n], sc[key][n]), (key, n)
    for key in ("m", "v"):
        for n in sa["opt"][key]:
            assert torch.equal(sa["opt"][key][n], sc["opt"][key][n]), n


def test_launch_train_moe_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-moe-30b-a3b", "--reduced", "--layers", "2", "--device",
         "cpu", "--steps", "2", "--seq", "32"], env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "trained 2 steps" in res.stdout and "on cpu" in res.stdout
    assert "step 2: loss=" in res.stdout


def test_launch_train_layers_flag(capsys):
    from repro_torch.launch import train as train_launch
    with pytest.raises(SystemExit):
        train_launch.main(["--layers", "0", "--device", "cpu"])
    assert "--layers must be >= 1" in capsys.readouterr().err
