"""PyTorch port, slice 6g: the enc-dec family (seamless-m4t-large-v2)
against the JAX package.

Reduced seamless-m4t-large-v2 (2 encoder and 4 decoder layers, d_model 64,
4 heads over 2 kv heads of 16, GELU MLPs of 128 with biases, LayerNorm,
QKV biases, an untied head of 256, frames of 32) takes the JAX ``EncDec``
init's weights in both packages (``interop.load_jax_params`` maps the two
stacks ``enc_layers`` and ``dec_layers`` by name), its biases and norms
perturbed from numpy seed 0 so that every one of them matters.

- The config field for field; the GELU MLP and the cross paths of
  ``attn_apply`` and ``attn_decode_step`` against JAX's within 1e-6 (the
  cross cache unchanged by the step).
- The model: prefill logits and caches within 1e-5 under fp32 and greedy
  prefill + decode streams token for token under ``mirage``; decode after
  a prefill equal to the full forward; the loss within 1e-6 and every
  gradient leaf within 1e-5 of the leaf's largest magnitude under fp32
  and ``mirage`` (the cross-attention's key bias excepted: its gradient is
  0 in exact arithmetic, since a bias on every key shifts each query's
  scores by one constant that the softmax drops, so both packages hold f32
  roundoff there, held to 1e-6 of the model's largest gradient); ``remat``
  bit for bit.
- ``with_extras``' frames bit for bit, two fp32 training steps against
  JAX's and the port's checkpoint read by the JAX checkpointer, the
  training launcher's checkpoint too.
- ``mirage_rrns`` with stationary weights programmed under drift (JAX's
  tree carried over): the streams and the health integers of a prefill and
  decode equal JAX's.
- ``launch.serve`` refuses the arch with a ``ValueError`` naming the served
  path; ``load_jax_params``' mismatch errors on an ``EncDec`` tree.
"""

import copy
import dataclasses
import importlib.util
import pathlib

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
from repro.core import stationary as jstationary
from repro.core.precision import get_policy as jpolicy
from repro.data import pipeline as jpipeline
from repro.models import attention as jattention
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.obs import health as jhealth
from repro.runtime import trainer as jtrainer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import stationary
from repro_torch.core.precision import get_policy
from repro_torch.data import pipeline
from repro_torch.interop import (_by_name, _load, load_jax_params,
                                 load_jax_stationary, to_jax_train_state)
from repro_torch.launch import serve, train
from repro_torch.models import EncDec, attention, build_model, common
from repro_torch.models.lm import LM, LMCallOptions
from repro_torch.obs import health
from repro_torch.runtime import trainer

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
CAP = 24
# the cross-attention key bias: a zero gradient in exact arithmetic
ZERO_GRAD = "cross_attn.k.b"


def _perturb(tree, seed=0):
    """The JAX init's tree with its biases and norm scales drawn from numpy
    (the init makes them 0 and 1)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("b", "bias"):
                out[k] = jnp.asarray(0.1 * rng.normal(size=v.shape),
                                     jnp.float32)
            elif k == "scale":
                out[k] = jnp.asarray(1 + 0.1 * rng.normal(size=v.shape),
                                     jnp.float32)
            else:
                out[k] = v
        return out

    return walk(tree)


def _pair(policy, options=None):
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy(policy))
    params = _perturb(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_config(ARCH).reduced(), get_policy(policy),
                     options or LMCallOptions(), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=["fp32", "mirage"])
def pair(request):
    return request.param, _pair(request.param)


@pytest.fixture(scope="module")
def mirage_pair():
    return _pair("mirage")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _inputs(seed=0, B=2, F=12, L=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, F, 32)).astype(np.float32),
            rng.integers(0, 256, (B, L)).astype(np.int32))


def test_config_equals_jax_and_builds_encdec():
    a, b = jconfig(ARCH), get_config(ARCH)
    for f in ModelConfig.__dataclass_fields__:
        assert getattr(a, f) == getattr(b, f), f
        assert getattr(a.reduced(), f) == getattr(b.reduced(), f), f
    assert b.is_encdec and b.encoder_layers == 24 and b.n_layers == 24
    assert (b.family, b.frontend, b.vocab_size) == ("audio", "audio_stub",
                                                    256206)
    tm = build_model(b.reduced(), get_policy("fp32"), device="cpu")
    assert isinstance(tm, EncDec) and len(tm.enc_layers) == 2 and \
        len(tm.dec_layers) == 4
    assert tm.dec_layers[0].mlp.gate is None and \
        tm.dec_layers[0].cross_attn.q.b is not None
    # the decoder-only LM refuses the config and names EncDec
    with pytest.raises(ValueError, match="EncDec"):
        LM(b.reduced(), get_policy("fp32"), device="cpu")


def test_param_names_and_cache_spec_equal_jax(mirage_pair):
    jm, params, tm = mirage_pair
    want = set(_by_name(tm, jax.tree_util.tree_map(np.asarray, params)))
    assert want == {n for n, _ in tm.named_parameters()}
    assert sum(p.numel() for p in tm.parameters()) == sum(
        np.size(x) for x in jax.tree_util.tree_leaves(params))
    spec = tm.cache_spec(2, CAP, 12)
    jspec = jm.cache_spec(2, CAP, 12)
    assert {k: tuple(s) for k, (s, _) in spec.items()} == \
        {k: tuple(s) for k, (s, _) in jspec.items()}


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_gelu_mlp_equals_jax(policy):
    rng = np.random.default_rng(1)
    p = jcommon.mlp_init(jax.random.PRNGKey(3), 64, 128, "gelu", True)
    p = _perturb(p, seed=2)
    mod = common.MLP(64, 128, True, "gelu",
                     generator=torch.Generator().manual_seed(0),
                     device=torch.device("cpu"))
    assert mod.gate is None
    with torch.no_grad():
        _load(mod, jax.tree_util.tree_map(np.asarray, p), "")
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    want = jcommon.mlp(p, jnp.asarray(x), jpolicy(policy), "gelu")
    with torch.no_grad():
        got = common.mlp(mod, _t(x), get_policy(policy))
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="mlp_type"):
        common.MLP(4, 8, mlp_type="relu",
                   generator=torch.Generator(), device=torch.device("cpu"))


def _attn_pair(seed=4):
    p = _perturb(jattention.attn_init(jax.random.PRNGKey(seed), 64, 4, 2,
                                      16, True, False), seed=seed)
    mod = attention.Attention(64, 4, 2, 16, True, False,
                              generator=torch.Generator().manual_seed(0),
                              device=torch.device("cpu"))
    with torch.no_grad():
        _load(mod, jax.tree_util.tree_map(np.asarray, p), "")
    return p, mod


KW = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_cross_attn_apply_equals_jax(policy):
    """Queries from the decoder's 7 positions over 12 encoder rows (no
    rope, every key valid), and the encoder's own bidirectional
    self-attention with rope; the keys and values returned for the cache
    too. Plain attention on both sides (flash only for self-attention at
    the sequence's own positions)."""
    p, mod = _attn_pair()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    enc = rng.normal(size=(2, 12, 64)).astype(np.float32)
    jp, tp = jpolicy(policy), get_policy(policy)
    pos, epos = jnp.arange(7), jnp.arange(12)
    want, (wk, wv) = jattention.attn_apply(
        p, jnp.asarray(x), jp, positions=pos, causal=False,
        x_kv=jnp.asarray(enc), use_rope=False, kv_positions=epos, **KW)
    with torch.no_grad():
        got, (k, v) = attention.attn_apply(
            mod, _t(x), tp, positions=torch.arange(7), causal=False,
            x_kv=_t(enc), use_flash=True, **KW)
    _close(got, want, 1e-6)
    _close(k, wk, 1e-6)
    _close(v, wv, 1e-6)
    want, _ = jattention.attn_apply(p, jnp.asarray(enc), jp, positions=epos,
                                    causal=False, **KW)
    with torch.no_grad():
        got, _ = attention.attn_apply(mod, _t(enc), tp,
                                      positions=torch.arange(12),
                                      causal=False, use_flash=True, **KW)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_cross_attn_decode_step_equals_jax_and_writes_nothing(policy):
    p, mod = _attn_pair(seed=6)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    idx = 5
    want, jk, jv = jattention.attn_decode_step(
        p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(idx, jnp.int32), jpolicy(policy), cross=True,
        use_rope=False, **KW)
    tk, tv = _t(ck).clone(), _t(cv).clone()
    with torch.no_grad():
        got, k2, v2 = attention.attn_decode_step(
            mod, _t(x), tk, tv, torch.tensor(idx, dtype=torch.int32),
            get_policy(policy), cross=True, **KW)
    _close(got, want, 1e-6)
    assert torch.equal(tk, _t(ck)) and torch.equal(tv, _t(cv))
    assert k2 is tk and v2 is tv
    np.testing.assert_array_equal(np.asarray(jk), ck)
    with pytest.raises(ValueError, match="self-attention cache"):
        attention.attn_decode_step(
            mod, _t(x), tk, tv, torch.tensor([5, 5]), get_policy(policy),
            cross=True, block_tables=torch.zeros((2, 3), dtype=torch.int32),
            **KW)


def test_prefill_equals_jax(pair):
    """Logits and every cache leaf: within 1e-5 under fp32, and under
    ``mirage`` too (the BFP-quantized GEMMs' folded products are exact,
    so only f32 sums reorder)."""
    policy, (jm, params, tm) = pair
    frames, toks = _inputs()
    jl, jc = jax.jit(lambda p, f, t: jm.prefill(p, f, t, CAP))(
        params, frames, toks)
    with torch.no_grad():
        log, c = tm.prefill(_t(frames), _t(toks), CAP)
    assert sorted(c) == sorted(jc) == ["cross_k", "cross_v", "idx",
                                       "self_k", "self_v"]
    assert tuple(c["self_k"].shape) == (4, 2, CAP, 2, 16)
    assert tuple(c["cross_k"].shape) == (4, 2, 12, 2, 16)
    assert c["idx"].dim() == 0 and int(c["idx"]) == 7
    _close(log, jl)
    for k in c:
        _close(c[k], jc[k])


def _greedy(jm, params, tm, frames, toks, n):
    jl, jc = jax.jit(lambda p, f, t: jm.prefill(p, f, t, CAP))(
        params, frames, toks)
    jdec = jax.jit(jm.decode_step)
    with torch.no_grad():
        log, c = tm.prefill(_t(frames), _t(toks), CAP)
    jstream, stream = [], []
    for _ in range(n):
        jn = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        tn = torch.argmax(log[:, -1], -1).to(torch.int32)[:, None]
        jstream.append(jn[:, 0].tolist())
        stream.append(tn[:, 0].tolist())
        jl, jc = jdec(params, jc, jn)
        with torch.no_grad():
            log, c = tm.decode_step(c, tn)
    return jstream, stream, (jl, jc), (log, c)


def test_greedy_stream_equals_jax(mirage_pair):
    """Prefill, then 8 greedy tokens under ``mirage``: token for token
    JAX's, the last logits and caches within 1e-5, the cross KV as the
    prefill left it."""
    jm, params, tm = mirage_pair
    frames, toks = _inputs(seed=1)
    jstream, stream, (jl, jc), (log, c) = _greedy(jm, params, tm, frames,
                                                  toks, 8)
    assert stream == jstream and len(stream) == 8
    _close(log, jl)
    for k in c:
        _close(c[k], jc[k])
    assert int(c["idx"]) == 7 + 8
    with torch.no_grad():
        _, c0 = tm.prefill(_t(frames), _t(toks), CAP)
    assert torch.equal(c["cross_k"], c0["cross_k"])


def test_decode_after_prefill_equals_forward():
    """Teacher-forced decode from a prefill of the first 6 tokens: each
    step's logits equal the full forward's at that position (the
    JAX package's ``test_prefill_then_decode``, held to the forward)."""
    _, _, tm = _pair("fp32")
    frames, toks = _inputs(seed=2, L=12)
    with torch.no_grad():
        full = tm.forward(_t(frames), _t(toks))
        log, c = tm.prefill(_t(frames), _t(toks[:, :6]), CAP)
        _close(log[:, -1], full[:, 5])
        for t in range(6, 12):
            log, c = tm.decode_step(c, _t(toks[:, t:t + 1]))
            _close(log[:, 0], full[:, t])
    assert int(c["idx"]) == 12


def _batch(seed=0, B=2, L=10):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(B, L, 32)).astype(np.float32),
            "tokens": rng.integers(0, 256, (B, L)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, L)).astype(np.int32)}


def _grads_close(tm, grads, jg, tol):
    names = [n for n, _ in tm.named_parameters()]
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in zip(names, grads):
        if name.endswith(ZERO_GRAD):
            assert float(g.abs().max()) <= 1e-6 * top, name
            assert float(np.abs(want[name]).max()) <= 1e-6 * top, name
            continue
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want[name] / scale,
                                   atol=tol, err_msg=name)


def test_loss_and_grads_equal_jax(pair):
    """Under fp32 and ``mirage``: the loss within 1e-6, every gradient
    leaf within 1e-5 of its leaf's largest magnitude (mirage's backward
    GEMMs round dO to BFP too, and every leaf stays within 2e-6 on this
    batch: the forward's f32 reorders do not cross a rounding boundary
    there)."""
    policy, (jm, params, tm) = pair
    batch = _batch()
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    loss, met = tm.loss({k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert float(met["aux"]) == 0.0
    np.testing.assert_allclose(float(met["ppl"]), float(jmet["ppl"]),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    _grads_close(tm, grads, jg, TOL)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exact_reference_grads_equal_port():
    """chip_smoke.py's f64 reference of the teacher-forced units (the
    layers written out in plain tensor ops, which its training phase holds
    the card's fp32 gradients against) against the port's fp32 CPU path:
    each unit's output and every gradient leaf within 1e-5 of its leaf's
    largest magnitude, the cross-attention key bias within 1e-6 of its
    unit's largest gradient on both sides."""
    cs = _chip_smoke()
    _, _, tm = _pair("fp32")
    exact = copy.deepcopy(tm).double()
    b = _batch(L=12)
    frames, toks = _t(b["frames"]), _t(b["tokens"]).long()
    pos, dec = torch.arange(12), (0, 3)
    inputs = {}
    with torch.no_grad():
        enc_out = tm.encode(frames)
        h = common.embed(tm.embed, toks)
        for li in range(4):
            inputs[li] = h
            want = tm.dec_layer(tm.dec_layers[li], h, pos, enc_out)[0]
            got = cs.exact_dec_layer(exact.cfg, exact.dec_layers[li],
                                     h.double(), pos, enc_out.double())
            _close(got.float() / want.abs().max(), want / want.abs().max())
            h = want
        x = common.dense(tm.frontend_proj, frames, tm.policy)
        want = tm.enc_layer(tm.enc_layers[0], x, pos)
        got = cs.exact_enc_layer(exact.cfg, exact.enc_layers[0], x.double(),
                                 pos)
        _close(got.float() / want.abs().max(), want / want.abs().max())
    sides = [cs.seamless_unit_grads(m, frames, inputs, enc_out, dec, "cpu",
                                    exact=m is exact) for m in (tm, exact)]
    for unit, want in sides[1].items():
        top = max(float(v.abs().max()) for v in want.values())
        for name, v in want.items():
            g = sides[0][unit][name]
            if name.endswith(ZERO_GRAD):
                assert float(g.abs().max()) <= 1e-6 * top, name
                assert float(v.abs().max()) <= 1e-6 * top, name
                continue
            scale = float(v.abs().max())
            _close(g / scale, (v / scale).float())


def test_remat_and_chunked_ce():
    """``remat`` (every encoder and decoder layer a checkpointed unit)
    gives the same loss and gradients bit for bit; ``ce_chunk`` the same
    loss as JAX's chunked CE within 1e-6."""
    jm, params, tm = _pair("mirage")
    batch = {k: _t(v) for k, v in _batch(seed=1).items()}
    out = []
    for opts in (LMCallOptions(), LMCallOptions(remat=True)):
        m = build_model(tm.cfg, tm.policy, opts, device="cpu")
        m.load_state_dict(tm.state_dict())
        loss, _ = m.loss(batch)
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    from repro.models.lm import LMCallOptions as JOptions
    jc = jbuild(jm.cfg, jm.policy, JOptions(ce_chunk=8))
    tc = build_model(tm.cfg, tm.policy, LMCallOptions(ce_chunk=8),
                     device="cpu")
    tc.load_state_dict(tm.state_dict())
    jloss, _ = jax.jit(jc.loss)(params, _batch(seed=1))
    with torch.no_grad():
        loss, _ = tc.loss(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def _source(module, cfg, seed=0):
    return module.SyntheticLM(module.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=10, batch_size=2, seed=seed))


def test_with_extras_frames_equal_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jconfig(ARCH).reduced()
    got = pipeline.with_extras(_source(pipeline, cfg), cfg)
    want = jpipeline.with_extras(_source(jpipeline, jcfg), jcfg)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["frames", "labels", "tokens"]
        assert a["frames"].shape == (2, 10, 32)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_training_steps_and_checkpoint_equal_jax(tmp_path):
    """Two fp32 AdamW steps (lr 1e-3, clip 1.0) on ``with_extras``
    batches against JAX's train step; the port's checkpoint, in the JAX
    layout with its ``enc_layers`` and ``dec_layers`` stacks, read by the
    JAX checkpointer bit for bit."""
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy("fp32"))
    jtc = JTrainConfig(policy=jpolicy("fp32"), optimizer="adamw", lr=1e-3)
    jstate = jtrainer.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).reduced(), get_policy("fp32"),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray,
                                               jstate["params"]))
    tc = TrainConfig(policy=get_policy("fp32"), optimizer="adamw", lr=1e-3)
    state = trainer.init_train_state(tm, tc)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    step = trainer.make_train_step(tm, tc)
    jdata = jpipeline.with_extras(_source(jpipeline, cfg), cfg)
    data = pipeline.with_extras(_source(pipeline, tm.cfg), tm.cfg)
    for _ in range(2):
        jstate, jmet = jstep(jstate, next(jdata))
        state, met = step(state, next(data))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=TOL)
    Checkpointer(str(tmp_path)).save(to_jax_train_state(tm, state), step=2)
    template = jax.tree_util.tree_map(np.zeros_like, jstate)
    got, _ = JCheckpointer(str(tmp_path)).restore(template, 2)
    flat = jflatten(got)
    assert any("enc_layers" in p for p in flat) and \
        any("dec_layers" in p and "cross_attn" in p for p in flat)
    want = jflatten(jax.tree_util.tree_map(np.asarray,
                                           to_jax_train_state(tm, state)))
    assert sorted(flat) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(np.asarray(flat[path]), arr, path)
    jp = _by_name(tm, jax.tree_util.tree_map(np.asarray, jstate["params"]))
    for name, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), jp[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_train_launcher_checkpoint_reads_into_jax(tmp_path, capsys):
    """``launch.train --arch seamless-m4t-large-v2 --reduced`` trains two
    steps on the frames ``with_extras`` draws and checkpoints in the JAX
    layout; the JAX checkpointer reads it into a JAX train state's
    template."""
    assert train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "2", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "1"]) == 0
    assert "trained 2 steps" in capsys.readouterr().out
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy("mirage"))
    jtc = JTrainConfig(policy=jpolicy("mirage"), optimizer="adamw", lr=1e-3)
    template = jax.tree_util.tree_map(
        np.zeros_like, jtrainer.init_train_state(jm, jtc,
                                                 jax.random.PRNGKey(0)))
    ckpt = JCheckpointer(str(tmp_path))
    assert ckpt.latest_step() == 2
    got, _ = ckpt.restore(template, 2)
    assert int(got["step"]) == 2
    assert got["params"]["dec_layers"]["cross_attn"]["q"]["w"].shape == \
        (4, 64, 64)
    assert all(np.all(np.isfinite(np.asarray(x)))
               for x in jax.tree_util.tree_leaves(got))
    # --layers cuts both stacks
    assert train.main(["--arch", ARCH, "--reduced", "--layers", "1",
                       "--device", "cpu", "--steps", "1"]) == 0


def test_rrns_stationary_health_equals_jax(mirage_pair):
    """``mirage_rrns`` with every GEMM weight programmed once under
    programming drift (JAX's encoded tree carried over by
    ``load_jax_stationary``): a prefill and 2 greedy decode steps give
    JAX's tokens, and the health integers of both packages' collection
    scopes are equal (drift moves residues that the RRNS decode
    corrects)."""
    _, params, base = mirage_pair
    kw = dict(phase_drift_sigma=0.1, noise_seed=11)
    jp, tp = jpolicy("mirage_rrns", **kw), get_policy("mirage_rrns", **kw)
    jm = jbuild(jconfig(ARCH).reduced(), jp)
    enc = jax.jit(lambda t: jstationary.encode_stationary_params(t, jp))(
        params)
    tm = build_model(base.cfg, tp, device="cpu")
    tm.load_state_dict(base.state_dict())
    carried = load_jax_stationary(tm, jax.tree_util.tree_map(np.asarray,
                                                             enc))
    assert "enc_layers.1.mlp.up" in carried and \
        "dec_layers.3.cross_attn.o" in carried and "lm_head" in carried
    stationary.install(tm, carried)
    frames, toks = _inputs(seed=3, L=5)

    def jrun(p, f, t):
        with jhealth.collect() as hc:
            log, c = jm.prefill(p, f, t, CAP)
            toks_out = []
            for _ in range(2):
                nxt = jnp.argmax(log[:, -1], -1).astype(jnp.int32)[:, None]
                toks_out.append(nxt[:, 0])
                log, c = jm.decode_step(p, c, nxt)
        return jnp.stack(toks_out, 1), log, dict(hc.values)

    jtoks, jlog, jvals = jax.jit(jrun)(enc, frames, toks)
    with torch.no_grad(), health.collect() as hc:
        log, c = tm.prefill(_t(frames), _t(toks), CAP)
        got = []
        for _ in range(2):
            nxt = torch.argmax(log[:, -1], -1).to(torch.int32)[:, None]
            got.append(nxt[:, 0])
            log, c = tm.decode_step(c, nxt)
    assert torch.stack(got, 1).tolist() == np.asarray(jtoks).tolist()
    _close(log, jlog)
    assert jvals and sorted(jvals) == sorted(hc.values)
    for k, v in jvals.items():
        np.testing.assert_array_equal(hc.values[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert int(hc.values["rrns_corrected"]) > 0
    assert int(hc.values["rrns_uncorrected"]) == 0


def test_serve_launcher_refuses_with_the_served_path():
    with pytest.raises(ValueError, match="EncDec.prefill"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_load_jax_params_rejects_mismatched_encdec_trees(mirage_pair):
    _, params, tm = mirage_pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    bad = dict(tree, dec_layers=dict(
        tree["dec_layers"], ln_x={"scale": np.ones((4, 3), np.float32),
                                  "bias": tree["dec_layers"]["ln_x"]
                                  ["bias"]}))
    with pytest.raises(ValueError, match=r"dec_layers\[0\]\.ln_x\.scale"):
        load_jax_params(tm, bad)
    partial = {k: v for k, v in tree.items() if k != "enc_layers"}
    with pytest.raises(ValueError, match="does not cover"):
        load_jax_params(tm, partial)
    extra = dict(tree, enc_layers=dict(tree["enc_layers"],
                                       cross_attn=tree["dec_layers"]
                                       ["cross_attn"]))
    with pytest.raises(KeyError, match=r"enc_layers\[0\]\.cross_attn"):
        load_jax_params(tm, extra)
    # a stack cut short leaves layers unloaded
    cut = dict(tree, dec_layers=jax.tree_util.tree_map(lambda a: a[:2],
                                                       tree["dec_layers"]))
    short = build_model(dataclasses.replace(tm.cfg, n_layers=2), tm.policy,
                        device="cpu")
    load_jax_params(short, cut)
    with pytest.raises(IndexError):
        load_jax_params(tm, cut)
