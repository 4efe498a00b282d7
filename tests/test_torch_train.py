"""PyTorch port, slice 2: training against the JAX package.

The same numpy-seeded inputs go through the JAX function and the port's.
GEMM gradients are held to ``jax.vjp`` of ``repro.core.gemm.mirage_matmul``
at rtol = atol = 1e-6 (both packages quantize the same operands bit for
bit; only the order of f32 sums differs); the reduced model's loss and
gradients to ``jax.value_and_grad(model.loss)``; the quickstart's training
run (``examples/quickstart.py``: reduced qwen2-0.5b, seq 48, batch 4, AdamW
lr 1e-3) step loss by step loss, rtol 1e-5 under ``fp32`` and 1e-3 under
``mirage``. The JAX package is the reference and runs as its own tests run
it on the CPU (plain paths). Kernel checks at the backward shapes need the
card and carry the ``cuda`` marker.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import gemm as jgemm
from repro.core.precision import get_policy as jpolicy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import SyntheticLMConfig as JSyntheticLMConfig
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import trainer as jtrainer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import gemm
from repro_torch.core.precision import get_policy
from repro_torch.core.stationary import StationaryResidues
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import _by_name, load_jax_params, \
    load_jax_train_state
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, common
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import trainer

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------
# the differentiable GEMM against jax.vjp
# --------------------------------------------------------------------------

def _wsq_weight(w, b_m=4, g=16):
    """w on its BFP grid along K (what weight-stationary training feeds)."""
    return ref.bfp_fake_quant_ref(torch.from_numpy(w).T, b_m, g).T.numpy() \
        .copy()


@pytest.mark.parametrize("mode,aq", [("fp32", False), ("mirage", False),
                                     ("mirage", True), ("mirage_rns", False)])
@pytest.mark.parametrize("shape", [(2, 5, 37, 9),    # ragged K, 10 tokens
                                   (3, 7, 48, 20),   # 21 tokens % 16 != 0
                                   (1, 16, 64, 16)])
def test_gemm_function_matches_jax_vjp(mode, aq, shape):
    B, L, K, N = shape
    x = _rand((B, L, K), 1)
    w = _rand((K, N), 2, 1 / np.sqrt(K))
    if aq:
        w = _wsq_weight(w)
    dout = _rand((B, L, N), 3)
    jp = jpolicy(mode, assume_quantized_weights=aq)

    @jax.jit   # one XLA compile instead of the eager op-by-op ones
    def fwd_bwd(a, b, d):
        out, vjp = jax.vjp(lambda a, b: jgemm.mirage_matmul(a, b, jp), a, b)
        return (out,) + vjp(d)
    want, jdx, jdw = fwd_bwd(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(dout))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = gemm.mirage_matmul(tx, tw, get_policy(mode,
                                                assume_quantized_weights=aq))
    got.backward(torch.from_numpy(dout))
    _close(got.detach(), want, 1e-6)
    _close(tx.grad, jdx, 1e-6)
    _close(tw.grad, jdw, 1e-6)


@pytest.mark.parametrize("layout", ["contiguous", "prequantized"])
def test_gemm_function_wsq_dx_takes_the_weight_as_it_is(layout):
    """Under assume_quantized_weights dX reads the stored grid values
    (regrouping them along N would change them), as the JAX backward; also
    in the trainer's layout (a transposed view of a contiguous (N, K)
    copy, whose dX operand W^T is that copy)."""
    x, w, dout = _rand((6, 32), 4), _wsq_weight(_rand((32, 24), 5)), \
        _rand((6, 24), 6)
    tw = torch.from_numpy(w)
    if layout == "prequantized":
        tw = trainer._prequantize_params({"mlp.w": tw}, get_policy("mirage"),
                                         torch.float32)["mlp.w"].detach()
        assert tw.T.is_contiguous() and torch.equal(tw, torch.from_numpy(w))
    pol = get_policy("mirage", assume_quantized_weights=True)
    tx = torch.from_numpy(x).requires_grad_()
    gemm.mirage_matmul(tx, tw, pol).backward(torch.from_numpy(dout))
    want = ref.mirage_gemm_ref(torch.from_numpy(dout), tw.T,
                               quantize_w=False)
    regrouped = ref.mirage_gemm_ref(torch.from_numpy(dout), tw.T)
    _close(tx.grad, want, 1e-6)
    assert not torch.allclose(tx.grad, regrouped, rtol=1e-6, atol=1e-6)


def test_tied_head_emb_grad_matches_jax():
    """The tied head reads emb.T; its weight gradient reaches emb through
    the transpose (plus nothing else here)."""
    x, emb, dout = _rand((2, 9, 32), 7), _rand((50, 32), 8, 0.02), \
        _rand((2, 9, 50), 9)
    jp = jpolicy("mirage")
    (want,) = jax.jit(lambda e, d: jax.vjp(lambda e: jcommon.unembed(
        {"emb": e}, jnp.asarray(x), jp), e)[1](d))(jnp.asarray(emb),
                                                   jnp.asarray(dout))
    p = common.Embed.__new__(common.Embed)
    torch.nn.Module.__init__(p)
    p.emb = torch.nn.Parameter(torch.from_numpy(emb))
    common.unembed(p, torch.from_numpy(x), get_policy("mirage")).backward(
        torch.from_numpy(dout))
    _close(p.emb.grad, want, 1e-6)


def test_gemm_auto_takes_the_function_only_under_grad():
    x = torch.from_numpy(_rand((3, 16), 10)).requires_grad_()
    w = torch.from_numpy(_rand((16, 4), 11)).requires_grad_()
    pol = get_policy("mirage")
    assert gemm.mirage_matmul_auto(x, w, pol).grad_fn is not None
    with torch.no_grad():
        assert gemm.mirage_matmul_auto(x, w, pol).grad_fn is None
    sr = StationaryResidues(residues=torch.zeros((5, 1, 16, 4),
                                                 dtype=torch.int32),
                            scale=torch.ones((1, 4)), moduli=(31, 32, 33),
                            b_m=4, g=16, orig_k=16)
    with pytest.raises(TypeError, match="no gradient"):
        gemm.mirage_matmul_auto(x, sr, get_policy("mirage_rns"))


# --------------------------------------------------------------------------
# forward-only wrappers refuse to cut the graph
# --------------------------------------------------------------------------

def _wrapper_calls():
    pol = get_policy("mirage")
    x = torch.randn(4, 32)
    w = torch.randn(32, 8)
    q, kv = torch.randn(1, 5, 4, 64), torch.randn(1, 5, 2, 64)
    moduli = (31, 32, 33)
    xr = torch.zeros((3, 1, 2, 16), dtype=torch.int32)
    wr = torch.zeros((3, 1, 16, 4), dtype=torch.int32)
    noise = torch.randn(3, 1, 2, 4)
    from repro_torch.analog import rrns
    tables = rrns.get_tables((31, 32, 33, 37, 41), 3, 16367)
    return {
        "bfp_fake_quant": (lambda a: ops.bfp_fake_quant(a, pol), [x]),
        "mirage_matmul_fused": (lambda a, b: ops.mirage_matmul_fused(
            a, b, pol), [x, w]),
        "flash_attention": (lambda a, b, c: ops.flash_attention(a, b, c),
                            [q, kv, kv.clone()]),
        "rns_group_matmul_channel": (
            lambda n: ops.rns_group_matmul_channel(xr, wr, moduli, n),
            [noise]),
    }, (xr, wr, moduli, tables)


@pytest.mark.parametrize("name", ["bfp_fake_quant", "mirage_matmul_fused",
                                  "flash_attention",
                                  "rns_group_matmul_channel"])
def test_wrappers_refuse_inputs_that_require_grad(name):
    calls, _ = _wrapper_calls()
    fn, args = calls[name]
    fn(*args)                                   # plain tensors: fine
    args = [a.clone().requires_grad_() for a in args]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args)
    with torch.no_grad():
        assert fn(*args).grad_fn is None


def test_integer_wrappers_are_forward_only():
    """rns_group_matmul and rrns_decode take integer residues, which cannot
    require grad; their guard passes them and the plain versions run."""
    _, (xr, wr, moduli, tables) = _wrapper_calls()
    res = ops.rns_group_matmul(xr, wr, moduli)
    full = torch.zeros((5,) + tuple(res.shape[1:]), dtype=torch.int32)
    dec, votes = ops.rrns_decode(full, tables)
    assert dec.grad_fn is None and votes.grad_fn is None
    with pytest.raises(RuntimeError, match="forward-only"):
        ops._forward_only("rrns_decode", "nothing",
                          torch.zeros(2, requires_grad=True))


# --------------------------------------------------------------------------
# the model's loss and gradients against jax.value_and_grad
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    """The JAX init of the reduced config, run once for the module: every
    policy and option draws the same parameters."""
    return jbuild(jconfig("qwen2-0.5b").reduced(), jpolicy("fp32"),
                  JOptions(q_chunk=32, kv_chunk=32)).init(
                      jax.random.PRNGKey(0))


def _pair(policy, params, **opts):
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy(policy), JOptions(q_chunk=32, kv_chunk=32,
                                              **opts))
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    tm = build_model(ModelConfig(**fields), get_policy(policy),
                     LMCallOptions(q_chunk=32, kv_chunk=32, **opts),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _batch(seq=48, batch=4, step=0):
    return JSyntheticLM(JSyntheticLMConfig(vocab_size=256, seq_len=seq,
                                           batch_size=batch)).batch_at(step)


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
@pytest.mark.parametrize("opts", [{}, {"ce_chunk": 40, "remat": True}],
                         ids=["plain", "ce_chunk_remat"])
def test_loss_and_grads_match_jax(jax_params, policy, opts):
    jm, params, tm = _pair(policy, jax_params, **opts)
    b = _batch()
    # jitted: one XLA compile instead of the eager op-by-op ones
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tmet = tm.loss({k: torch.from_numpy(v) for k, v in b.items()})
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in tm.named_parameters()])
    _close(tl.detach(), jl, 1e-5)
    _close(tmet["ppl"].detach(), jmet["ppl"], 1e-4)
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    for n, g in zip(names, grads):
        scale = float(np.abs(want[n]).max()) + 1e-30
        # relative to the leaf's largest gradient: the key bias has a
        # gradient of rounding size only (softmax ignores it)
        assert float(np.abs(g.numpy() - want[n]).max()) <= 1e-4 * scale \
            + 1e-8, n


def test_flash_attention_only_where_the_options_ask(monkeypatch,
                                                   jax_params):
    """Full-sequence attention goes to the flash kernel's wrapper exactly
    where ``LMCallOptions.use_flash_kernel`` is set (serving); training
    keeps the default, the plain attention, as the JAX package does. With
    the option set, a forward that needs the graph raises rather than
    losing the gradient."""
    from repro_torch.models import attention
    calls = []
    inner = attention.ops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(attention.ops, "flash_attention", spy)
    _, _, plain = _pair("fp32", jax_params)
    flash = build_model(plain.cfg, get_policy("fp32"),
                        LMCallOptions(use_flash_kernel=True), device="cpu")
    flash.load_state_dict(plain.state_dict())
    toks = torch.from_numpy(_batch(seq=40)["tokens"])
    b = {k: torch.from_numpy(v) for k, v in _batch(seq=40).items()}
    plain.loss(b)[0].backward()
    assert not calls
    with torch.inference_mode():
        want = plain(toks)
        got = flash(toks)
    assert len(calls) == plain.cfg.n_layers
    _close(got, want, 1e-5)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash.loss(b)


# --------------------------------------------------------------------------
# the quickstart's training run, step by step
# --------------------------------------------------------------------------

def _train_both(policy, steps, seq=48, batch=4, tc_kw=None, pol_kw=None,
                jit=True, first=None):
    """Both packages' steps side by side; ``first`` (a dict) receives both
    states' params after step 1, as numpy trees."""
    tc_kw, pol_kw = tc_kw or {}, pol_kw or {}
    cfg = jconfig("qwen2-0.5b").reduced()
    jp = jpolicy(policy, **pol_kw)
    jm = jbuild(cfg, jp, JOptions(q_chunk=32, kv_chunk=32))
    jtc = JTrainConfig(policy=jp, optimizer="adamw", lr=1e-3, **tc_kw)
    jstate = jtrainer.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    tp = get_policy(policy, **pol_kw)
    tm = build_model(ModelConfig(**fields), tp,
                     LMCallOptions(q_chunk=32, kv_chunk=32), device="cpu")
    ttc = TrainConfig(policy=tp, optimizer="adamw", lr=1e-3, **tc_kw)
    tstate = load_jax_train_state(
        tm, jax.tree_util.tree_map(np.asarray, jstate), ttc)
    jstep = jtrainer.make_train_step(jm, jtc)
    jstep = jax.jit(jstep) if jit else jstep
    tstep = trainer.make_train_step(tm, ttc)
    jdata = JSyntheticLM(JSyntheticLMConfig(vocab_size=256, seq_len=seq,
                                            batch_size=batch))
    tdata = SyntheticLM(SyntheticLMConfig(vocab_size=256, seq_len=seq,
                                          batch_size=batch))
    out = []
    for i in range(steps):
        jstate, jmet = jstep(jstate, next(jdata))
        tstate, tmet = tstep(tstate, next(tdata))
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    float(jmet["grad_norm"]), float(tmet["grad_norm"])))
        if i == 0 and first is not None:
            first["jax"] = _by_name(tm, jax.tree_util.tree_map(
                np.asarray, jstate["params"]))
            first["port"] = {n: p.detach().numpy().copy()
                             for n, p in tstate["params"].items()}
    return np.array(out), jstate, tstate, tm


def test_quickstart_trajectory_matches_jax_fp32():
    traj, jstate, tstate, tm = _train_both("fp32", steps=10)
    np.testing.assert_allclose(traj[:, 1], traj[:, 0], rtol=1e-5)
    np.testing.assert_allclose(traj[:, 3], traj[:, 2], rtol=1e-5)
    assert traj[-1, 1] < traj[0, 1]          # the loss goes down
    assert int(tstate["step"]) == 10


def test_quickstart_trajectory_mirage_step_one_exact_then_chaotic():
    """Under mirage the two trajectories agree to rounding until a BFP
    rounding boundary is crossed: at step 3 an f32 order difference moves
    a gradient element of the backward GEMMs across one (the grad norms
    part at 5e-5 while the losses still agree to 1e-7), Adam turns the
    near-zero gradients it touches into full +-lr steps, and from step 4
    the losses part at ~1e-3 (5.5478 vs 5.5510). So the gate is step 1:
    its loss, grad norm and every updated parameter (the per-parameter
    step-1 gradients are held in test_loss_and_grads_match_jax); over the
    10 steps both runs must learn."""
    first = {}
    traj, _, _, _ = _train_both("mirage", steps=10, first=first)
    np.testing.assert_allclose(traj[0, 1], traj[0, 0], rtol=1e-6)
    np.testing.assert_allclose(traj[0, 3], traj[0, 2], rtol=1e-6)
    for n, p in first["port"].items():
        # Adam moves each element by ~lr; 1e-5 is 1% of one update
        np.testing.assert_allclose(p, first["jax"][n], rtol=0, atol=1e-5,
                                   err_msg=n)
    assert traj[-1, 0] < traj[0, 0] and traj[-1, 1] < traj[0, 1]


def test_microbatches_match_one_batch():
    """Two microbatches of 2 average to the gradient of one batch of 4.
    SGD-M makes the update proportional to the gradient (Adam's first
    step is +-lr wherever a gradient is nonzero, whatever its size)."""
    tms = []
    for nmb in (1, 2):
        cfg = jconfig("qwen2-0.5b").reduced()
        fields = {f: getattr(cfg, f)
                  for f in ModelConfig.__dataclass_fields__}
        tm = build_model(ModelConfig(**fields), get_policy("fp32"),
                         LMCallOptions(q_chunk=32, kv_chunk=32),
                         device="cpu")
        tc = TrainConfig(policy=get_policy("fp32"), optimizer="sgdm",
                         lr=1e-2, microbatches=nmb)
        state = trainer.init_train_state(tm, tc)
        _, met = trainer.make_train_step(tm, tc)(state, _batch(seq=32))
        tms.append((tm, float(met["loss"]), float(met["grad_norm"])))
    (a, la, ga), (b, lb, gb) = tms
    assert la == pytest.approx(lb, rel=1e-6)
    assert ga == pytest.approx(gb, rel=1e-5)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        _close(q.detach(), p.detach(), 1e-6)


def test_wsq_with_bfp_compression_matches_jax_steps():
    """Weight-stationary quantization (bf16 copies) and BFP gradient
    compression with error feedback, 4 steps, against the JAX step losses
    (the reference's own convergence test is red; its steps are the
    yardstick)."""
    traj, jstate, tstate, tm = _train_both(
        "mirage", steps=4, seq=32,
        tc_kw=dict(weight_stationary_quant=True,
                   quant_param_dtype="bfloat16", grad_compression="bfp"),
        pol_kw=dict(assume_quantized_weights=True))
    np.testing.assert_allclose(traj[:, 1], traj[:, 0], rtol=1e-3)
    np.testing.assert_allclose(traj[:, 3], traj[:, 2], rtol=1e-3)
    assert set(tstate["err"]) == set(tstate["params"])


def test_prequantize_matches_jax(jax_params):
    from repro.runtime.trainer import _prequantize_params as jpre
    jm, params, tm = _pair("mirage", jax_params)
    pol = get_policy("mirage")
    got = trainer._prequantize_params(dict(tm.named_parameters()), pol,
                                      torch.float32)
    want = _by_name(tm, jax.tree_util.tree_map(
        np.asarray, jpre(params, jpolicy("mirage"), jnp.float32)))
    quantized = trainer._quantized_names(dict(tm.named_parameters()))
    assert len(quantized) == 7 * tm.cfg.n_layers
    for n, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[n], err_msg=n)
        assert t.requires_grad


def test_load_jax_train_state_round_trip():
    traj, jstate, tstate, tm = _train_both("fp32", steps=2, seq=16,
                                           tc_kw=dict(grad_compression="bfp"))
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    fresh = build_model(tm.cfg, get_policy("fp32"),
                        LMCallOptions(q_chunk=32, kv_chunk=32), device="cpu")
    tc = TrainConfig(policy=get_policy("fp32"), lr=1e-3,
                     grad_compression="bfp")
    st = load_jax_train_state(fresh, jnp_state, tc)
    assert int(st["step"]) == 2 and int(st["opt"]["count"]) == 2
    for key, tree in (("params", jnp_state["params"]),
                      ("err", jnp_state["err"])):
        for n, arr in _by_name(fresh, tree).items():
            np.testing.assert_array_equal(st[key][n].detach().numpy(), arr)
    for n, arr in _by_name(fresh, jnp_state["opt"]["m"]).items():
        np.testing.assert_array_equal(st["opt"]["m"][n].numpy(), arr)
    assert st["params"]["embed.emb"] is fresh.embed.emb


def test_launch_train_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "2", "--seq", "16"], env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "trained 2 steps" in res.stdout and "on cpu" in res.stdout
    # --distributed without torchrun's environment says what it needs
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "1", "--distributed"], env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "torchrun" in res.stderr
    # and trains as one torchrun rank on the CPU (gloo); two ranks are
    # held to one process in tests/test_torch_distributed.py
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "1", "--seq", "16", "--distributed"],
        env=dict(env, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "trained 1 steps" in res.stdout


# --------------------------------------------------------------------------
# the readout kernel's own flip count (ROADMAP queue 3)
# --------------------------------------------------------------------------

def test_readout_counts_the_residues_the_noise_moved(monkeypatch):
    """An exact f32 tie: residue 38 of modulus 41 plus noise -0.5000015
    sums to exactly 37.5, which rounds half to even back to 38. The draw
    rule round(n) % m != 0 counts a flip there; the residue did not move.
    The readout's own count (plain version here, the kernel's epilogue on
    the card) equals the JAX default route's (``channel.phase_noise`` fed
    the same noise), which compares the residues after the noise with
    those before."""
    from repro.analog import channel as jchannel
    moduli = (31, 32, 33, 37, 41)
    vals = np.array([5, 7, 38])                    # one row of 3 outputs
    xr = np.ones((5, 1, 1, 1), np.int32)
    wr = np.stack([vals % m for m in moduli]).astype(np.int32)[:, None,
                                                               None, :]
    noise = np.zeros((5, 1, 1, 3), np.float32)
    noise[4, 0, 0, 2] = np.float32(-0.5000015)       # the tie
    noise[4, 0, 0, 0] = np.float32(0.7)              # a plain flip
    noise[0, 0, 0, 1] = np.float32(-0.3)             # no flip
    assert np.float32(38.0) + noise[4, 0, 0, 2] == np.float32(37.5)
    res, flips = ops.rns_group_matmul_channel(
        torch.from_numpy(xr), torch.from_numpy(wr), moduli,
        torch.from_numpy(noise), count_flips=True)
    assert int(res[4, 0, 0, 2]) == 38 and int(res[4, 0, 0, 0]) == 6
    drawn = [int((np.remainder(np.round(noise[i]), m) != 0).sum())
             for i, m in enumerate(moduli)]
    clean = jnp.asarray(wr)                        # x = 1: out = w
    monkeypatch.setattr(jchannel.jax.random, "normal",
                        lambda key, shape: jnp.asarray(noise))
    noisy = jchannel.phase_noise(clean, moduli, (1.0,) * 5,
                                 jax.random.PRNGKey(0))
    jax_count = np.asarray(jnp.sum(noisy != clean, axis=(1, 2, 3)))
    np.testing.assert_array_equal(res.numpy(), np.asarray(noisy))
    assert flips.tolist() == jax_count.tolist() == [0, 0, 0, 0, 1]
    assert drawn == [0, 0, 0, 0, 2]


# --------------------------------------------------------------------------
# on the card: the GEMM kernel at the backward shapes
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _gemm_bound(x, w, b_m=4, g=16, quantize_w=True):
    xq = ref.bfp_fake_quant_ref(x.cpu(), b_m, g)
    wq = ref.bfp_fake_quant_ref(w.cpu().T, b_m, g).T if quantize_w \
        else w.cpu()
    return 1e-5 * (xq.abs().double() @ wq.abs().double()) + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [256, 150])
@pytest.mark.parametrize("K,N", [(896, 896), (896, 128), (896, 4864),
                                 (4864, 896)])
def test_cuda_gemm_backward_shapes(cuda, tokens, K, N):
    """dX = dO @ W^T (the (N, K) read of a contiguous (K, N) weight) and
    dW = X^T @ dO (X^T copied once, a ragged K of 150 tokens); and the
    weight-stationary forward and dX, which take the weight as it is in
    the trainer's layout (``_prequantize_params``: a transposed view of a
    contiguous (N, K) copy, so dX reads that copy row-major), against the
    plain version."""
    pol = get_policy("mirage")
    x = torch.from_numpy(_rand((tokens, K), 1)).to(cuda)
    w = torch.from_numpy(_rand((K, N), 2, 1 / np.sqrt(K))).to(cuda)
    dout = torch.from_numpy(_rand((tokens, N), 3)).to(cuda)
    wq = trainer._prequantize_params({"mlp.w": w}, pol,
                                     torch.float32)["mlp.w"].detach()
    assert wq.T.is_contiguous()
    for a, b, qw in ((dout, w.T, True), (x, wq, False), (dout, wq.T, False),
                     (x.T, dout, True)):
        got = ops.mirage_matmul_fused(a, b, pol, quantize_w=qw)
        again = ops.mirage_matmul_fused(a, b, pol, quantize_w=qw)
        want = ref.mirage_gemm_ref(a, b, quantize_w=qw)
        tol = _gemm_bound(a, b, quantize_w=qw).to(cuda)
        assert bool(((got - want).abs() <= tol).all())
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_tied_head_backward(cuda):
    """The head's dX (emb read as (K = V, N = d)) and dW ((d, T) . (T, V))."""
    pol = get_policy("mirage")
    V, d, T = 151936, 896, 256
    emb = torch.from_numpy(_rand((V, d), 4, 0.02)).to(cuda)
    h = torch.from_numpy(_rand((T, d), 5)).to(cuda)
    dlog = torch.from_numpy(_rand((T, V), 6, 1e-3)).to(cuda)
    for a, b in ((dlog, emb), (h.T, dlog)):
        got = ops.mirage_matmul_fused(a, b, pol)
        want = ref.mirage_gemm_ref(a, b)
        tol = _gemm_bound(a, b).to(cuda)
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_train_step_launches(cuda):
    """One full-width-layer reduced step on the card: 3 GEMM launches per
    model GEMM, no flash launch (training attention is the plain path)."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b").reduced()
    tm = build_model(cfg, get_policy("mirage"), device=cuda)
    tc = TrainConfig(policy=get_policy("mirage"), lr=1e-3)
    state = trainer.init_train_state(tm, tc)
    ops.reset_launch_counts()
    trainer.make_train_step(tm, tc)(state, _batch(seq=32))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mirage_gemm"] == 3 * (7 * cfg.n_layers + 1)
    assert ops.LAUNCHES["flash_attention"] == 0
