"""PyTorch port, slice 6d: the vlm family (internvl2-2b) against the JAX
package.

Reduced internvl2-2b (4 layers, d_model 64, a frontend of 8 patches of
width 32, untied head) takes the JAX init's weights, ``frontend_proj``
included, in both packages. The stub vision tower's patch embeddings go
through ``fc2(gelu(fc1(x)))`` (the tanh gelu, ``jax.nn.gelu``'s default)
and lead the text tokens.

- ``with_extras`` batches equal the JAX package's bit for bit.
- The projected prefix (both frontend GEMMs and the gelu), the forward
  logits and the loss's value and gradients with patches, and
  ``prefill(extra_embeds=)``'s logits, cache and ``idx`` against JAX:
  under ``mirage`` the prefix and logits bit for bit, the rest within
  1e-5 (``fp32``: rtol = atol = 1e-5, the frameworks sum in other
  orders).
- Two training steps on ``with_extras`` batches against JAX's
  ``make_train_step``; the port's checkpoint read by JAX's
  ``Checkpointer`` into a JAX template bit for bit, ``frontend_proj``
  leaves included.
- The head GEMM at the published vocabulary N = 92,553 (odd: rows not
  16-byte aligned on the card) and its backward, whose dX contracts over
  K = 92,553 (a ragged last BFP group): the plain versions against JAX's
  ``mirage_matmul`` bit for bit.
- Text-only serving, as the JAX engine serves this family: the dense,
  paged, chunked and per-slot engines emit the JAX engine's streams.
- The launchers with ``--arch internvl2-2b``.
"""

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
from repro.core.gemm import mirage_matmul as jmatmul
from repro.core.precision import get_policy as jpolicy
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import trainer as jtrainer
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.gemm import mirage_matmul
from repro_torch.core.precision import get_policy
from repro_torch.data import pipeline
from repro_torch.interop import _by_name, load_jax_params, to_jax_train_state
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import trainer
from repro_torch.runtime.server import LMServer, PerSlotLMServer, Request

ARCH = "internvl2-2b"
TOL = 1e-5
ENGINE = dict(cap=24, batch_slots=2)
ENGINES = {
    "dense": {},
    "paged": dict(cache_layout="paged", block_size=4),
    "paged_chunk": dict(cache_layout="paged", block_size=4, prefill_chunk=4),
    "oracle": None,
}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX init of the reduced config, run once for the module (every
    policy draws the same parameters)."""
    return jbuild(jconfig(ARCH).reduced(), jpolicy("fp32"),
                  JOptions(q_chunk=16, kv_chunk=16)).init(
                      jax.random.PRNGKey(0))


def _pair(policy, params):
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy(policy), JOptions(q_chunk=16, kv_chunk=16))
    tm = build_model(get_config(ARCH).reduced(), get_policy(policy),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=["fp32", "mirage"])
def pair(request, jax_params):
    return request.param, _pair(request.param, jax_params)


def _source(module, cfg, batch=2, seq=12, seed=0):
    return module.SyntheticLM(module.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=seed))


def _batch(cfg, seed=0):
    """A batch of the reduced config: tokens, labels and patches."""
    return next(pipeline.with_extras(_source(pipeline, cfg, seed=seed), cfg))


def test_with_extras_batches_equal_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jconfig(ARCH).reduced()
    got = pipeline.with_extras(_source(pipeline, cfg), cfg)
    want = jpipeline.with_extras(_source(jpipeline, jcfg), jcfg)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["labels", "patches", "tokens"]
        assert a["patches"].shape == (2, 8, 32)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # other archs' batches pass through
    q = get_config("qwen2-0.5b").reduced()
    assert "patches" not in next(pipeline.with_extras(_source(pipeline, q), q))


def test_prefix_forward_loss_and_grads_equal_jax(pair):
    policy, (jm, params, tm) = pair
    batch = _batch(tm.cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jh, jn = jax.jit(lambda p, t, e: jm._embed_inputs(p, t, e))(
        params, batch["tokens"], batch["patches"])
    jl = jax.jit(lambda p, t, e: jm.forward(p, t, e)[0])(
        params, batch["tokens"], batch["patches"])
    with torch.no_grad():
        th, tn = tm._embed_inputs(tb["tokens"], tb["patches"])
        tl = tm.forward(tb["tokens"], tb["patches"])
    assert tn == jn == 8 and tl.shape == (2, 20, 256)
    if policy == "mirage":
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    loss, _ = tm.loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    params_t = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(params_t.values()))
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    assert {"frontend_proj.fc1.w", "frontend_proj.fc2.w"} <= set(want)
    for name, g in zip(params_t, grads):
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want[name] / scale,
                                   atol=TOL, err_msg=name)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((exact - got).abs().max()) > 1e-4


def test_prefill_with_patches_equals_jax(pair):
    """The P projected patches take positions 0..P-1 of the sequence and
    the cache, the prompt follows, idx = P + L; with ``lens`` counting
    positions of the whole sequence, the logits at each row's last real
    position."""
    policy, (jm, params, tm) = pair
    batch = _batch(tm.cfg, seed=1)
    toks, patches = batch["tokens"], batch["patches"]
    tt, tp = torch.from_numpy(toks), torch.from_numpy(patches)
    # jitted JAX references: one XLA compile each instead of eager ops
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    for lens in (None, np.array([20, 15], np.int32)):
        jl, jc = jprefill(params, jnp.asarray(toks), 32,
                          extra_embeds=jnp.asarray(patches),
                          lens=None if lens is None else jnp.asarray(lens))
        with torch.no_grad():
            tl, tc = tm.prefill(tt, 32, extra_embeds=tp,
                                lens=None if lens is None
                                else torch.from_numpy(lens))
        np.testing.assert_array_equal(tc["idx"].numpy(),
                                      np.asarray(jc["idx"]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[leaf].numpy(),
                                       np.asarray(jc[leaf]), rtol=TOL,
                                       atol=TOL)
    # decode steps from the prefix cache
    jd, _ = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, :1]))
    with torch.no_grad():
        td, _ = tm.decode_step(tc, tt[:, :1])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)


def test_text_model_has_no_frontend():
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy("fp32"),
                     device="cpu")
    with pytest.raises(ValueError, match="no frontend"):
        tm.forward(torch.zeros((1, 4), dtype=torch.int32),
                   torch.zeros((1, 8, 32)))


def test_training_steps_and_checkpoint_equal_jax(tmp_path):
    """Two mirage steps on ``with_extras`` batches (patches carried into
    ``loss``) against JAX's train step; the port's checkpoint read by the
    JAX checkpointer into a JAX template bit for bit."""
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(q_chunk=16, kv_chunk=16))
    jtc = JTrainConfig(policy=jpolicy("mirage"), optimizer="adamw", lr=1e-3)
    jstate = jtrainer.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray,
                                               jstate["params"]))
    tc = TrainConfig(policy=get_policy("mirage"), optimizer="adamw", lr=1e-3)
    state = trainer.init_train_state(tm, tc)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    step = trainer.make_train_step(tm, tc)
    jdata = jpipeline.with_extras(_source(jpipeline, cfg), cfg)
    data = pipeline.with_extras(_source(pipeline, tm.cfg), tm.cfg)
    for _ in range(2):
        jstate, jmet = jstep(jstate, next(jdata))
        state, met = step(state, next(data))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    Checkpointer(str(tmp_path)).save(to_jax_train_state(tm, state), step=2)
    template = jax.tree_util.tree_map(np.zeros_like, jstate)
    got, _ = JCheckpointer(str(tmp_path)).restore(template, 2)
    flat = jflatten(got)
    assert any("frontend_proj" in path for path in flat)
    want = jflatten(jax.tree_util.tree_map(np.asarray,
                                           to_jax_train_state(tm, state)))
    assert sorted(flat) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(np.asarray(flat[path]), arr, path)


def test_head_gemm_at_the_odd_vocabulary_equals_jax():
    """x (4, 64) @ w (64, 92553) and its backward: dX = dO (4, 92553) @
    w^T, grouped along K = 92,553 = 16 x 5,784 + 9, and dW, both through
    the plain versions, bit for bit against JAX's ``mirage_matmul``."""
    rng = np.random.default_rng(0)
    M, K, N = 4, 64, get_config(ARCH).vocab_size
    assert N % 16 == 9 and N % 4 == 1
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    dout = rng.standard_normal((M, N)).astype(np.float32)
    # jitted: one XLA compile instead of the eager op-by-op ones
    jy, jdx, jdw = jax.jit(lambda a, b, d: (lambda y, f: (y,) + f(d))(
        *jax.vjp(lambda a, b: jmatmul(a, b, jpolicy("mirage")), a, b)))(
            x, w, dout)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = mirage_matmul(xt, wt, get_policy("mirage"))
    dx, dw = torch.autograd.grad(y, [xt, wt], torch.from_numpy(dout))
    for got, want in ((y, jy), (dx, jdx), (dw, jdw)):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    with torch.no_grad():
        fused = ops.mirage_matmul_fused(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        get_policy("mirage"))
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jy))
    # the card's quantizer takes the scalar route on rows of that length
    assert ops.bfp_quant_plan(N, 16) == "scalar"


@pytest.fixture(scope="module")
def served(jax_params):
    jm, params, tm = _pair("mirage", jax_params)
    reqs = _requests(JRequest)
    server = JServer(jm, params, **ENGINE)
    for r in reqs:
        server.submit(r)
    want = {r.rid: r.tokens_out for r in server.run_until_drained()}
    return want, tm


def _requests(cls, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, 6 + 3 * i).astype(
        np.int32), max_tokens=4) for i in range(n)]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_text_engines_equal_jax_engine(served, engine):
    want, tm = served
    server = PerSlotLMServer(tm, **ENGINE) if engine == "oracle" else \
        LMServer(tm, **ENGINE, **ENGINES[engine])
    for r in _requests(Request):
        server.submit(r)
    got = {r.rid: r.tokens_out for r in server.run_until_drained()}
    assert len(got) == 4 and got == want, engine


def test_launchers_take_the_arch(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-tokens", "3"]) == 0
    assert f"[{ARCH} d_model=64 layers=4" in capsys.readouterr().out
    assert train.main(["--arch", ARCH, "--reduced", "--layers", "2",
                       "--device", "cpu", "--steps", "2"]) == 0
    assert "trained 2 steps" in capsys.readouterr().out
