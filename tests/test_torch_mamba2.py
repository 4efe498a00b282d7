"""PyTorch port, slice 6e: the SSM family (mamba2-2.7b) against the JAX
package.

Reduced mamba2-2.7b (4 layers, d_model 64, 16 SSD heads of P = 8, N = 16,
conv K = 4, chunk 16, untied head) takes the JAX init's weights in both
packages (``interop.load_jax_params`` maps ``layers.mamba.*`` by name).

- ``ssd_scan`` against the JAX ``ssd_scan`` and both against the
  sequential ``ssd_reference`` at L = 1, 16, 17 and 40 (one chunk, a full
  chunk, a padded chunk, three chunks), and with an ``init_state``: a
  scan split in two, the second half carried from the first's state,
  against the whole scan and JAX's split scan. allclose 1e-5: the port
  runs the JAX einsums as explicit contractions (no (B, Q, K, H, P)
  product), which sums the same terms in another order.
- ``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)``, within
  rtol 1e-6 of it (each framework's exp and log1p round on their own);
  the prefill conv (K shifted views in order, bias last) is JAX's
  ``_causal_conv`` run op by op bit for bit (within 1e-5 of XLA's fused
  kernel, which rounds on its own).
- One block: ``mamba_apply`` with ``return_cache`` and
  ``mamba_decode_step`` against JAX's under ``mirage``: cache shapes and
  the conv-state tails (raw ``in_proj`` rows) bit for bit, at T < K-1
  too (the left-padded tail), outputs and states within 1e-5.
- The LM: forward logits, loss and the gradient of every leaf under
  ``fp32`` and ``mirage`` (logits and loss within 1e-5, gradients within
  1e-4 of each leaf's largest magnitude: ``A_log``'s runs through the
  reordered scan); ``prefill`` then ``decode_step``, ``verify_step``'s
  per-token states and ``prefill_chunk`` against JAX's.
- Two AdamW steps against JAX's train step, and the port's checkpoint in
  the JAX layout read by JAX's ``Checkpointer`` bit for bit.
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
from repro.core.precision import get_policy as jpolicy
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild
from repro.models import mamba2 as jmamba
from repro.runtime import trainer as jtrainer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.data import pipeline
from repro_torch.interop import _by_name, load_jax_params, to_jax_train_state
from repro_torch.models import build_model, mamba2
from repro_torch.runtime import trainer

ARCH = "mamba2-2.7b"
TOL = 1e-5
GRAD_TOL = 1e-4


def _pair(policy):
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy(policy))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).reduced(), get_policy(policy),
                     device="cpu")
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


def _scan_inputs(L, seed=0, B=2, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("L", [1, 16, 17, 40])
@pytest.mark.parametrize("split", [False, True])
def test_ssd_scan_equals_jax_and_the_reference(L, split):
    chunk = 16
    args = _scan_inputs(L, seed=L)
    ref = mamba2.ssd_reference(*map(_t, args)).numpy()
    jref = np.asarray(jmamba.ssd_reference(*args))
    np.testing.assert_allclose(ref, jref, rtol=TOL, atol=TOL)
    if not split:
        y, st = mamba2.ssd_scan(*map(_t, args), chunk)
        jy, jst = jmamba.ssd_scan(*args, chunk)
    else:
        # the second half starts from the first half's final state
        a = max(L // 2, 1)
        head = [x[:, :a] if x.ndim > 1 else x for x in args]
        tail = [x[:, a:] if x.ndim > 1 else x for x in args]
        y1, st1 = mamba2.ssd_scan(*map(_t, head), chunk)
        jy1, jst1 = jmamba.ssd_scan(*head, chunk)
        if L > a:
            y2, st = mamba2.ssd_scan(*map(_t, tail), chunk, init_state=st1)
            jy2, jst = jmamba.ssd_scan(*tail, chunk, init_state=jst1)
            y = torch.cat([y1, y2], dim=1)
            jy = jnp.concatenate([jy1, jy2], axis=1)
        else:
            y, st, jy, jst = y1, st1, jy1, jst1
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(y.numpy(), jref, rtol=TOL, atol=TOL)


def test_softplus_and_the_prefill_conv_order_equal_jax():
    x = np.concatenate([np.linspace(-30, 30, 2001),
                        np.random.default_rng(0).normal(size=500) * 5]
                       ).astype(np.float32)
    got = mamba2.softplus(_t(x))
    assert torch.equal(got, torch.logaddexp(_t(x), torch.zeros(x.shape)))
    # exp and log1p are each framework's own approximations: a few ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=0)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    got = mamba2._causal_conv(_t(u), _t(w), _t(b)).numpy()
    # op by op, as the JAX source writes it: bit for bit; XLA's fused
    # kernel under jit rounds on its own
    np.testing.assert_array_equal(got, np.asarray(jmamba._causal_conv(u, w,
                                                                      b)))
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(jmamba._causal_conv)(u, w, b)), rtol=TOL,
        atol=TOL)


def _block(tm, params, li=0):
    jp = jax.tree_util.tree_map(lambda a: a[li], params["layers"]["mamba"])
    return tm.layers[li].mamba, jp


@pytest.mark.parametrize("T", [1, 2, 12])
def test_block_apply_and_decode_equal_jax(mirage_pair, T):
    """``mamba_apply(return_cache=True)`` then ``mamba_decode_step``: the
    conv-state tails are raw ``in_proj`` rows, bit for bit (left-padded
    below K-1 tokens)."""
    jm, params, tm = mirage_pair
    cfg, jcfg = tm.cfg, jm.cfg
    p, jp = _block(tm, params)
    x = np.random.default_rng(T).normal(size=(2, T, cfg.d_model)).astype(
        np.float32)
    xd = np.random.default_rng(T + 1).normal(size=(2, 1, cfg.d_model)
                                              ).astype(np.float32)
    with torch.no_grad():
        out, (st, cv) = mamba2.mamba_apply(p, _t(x), cfg, tm.policy,
                                           return_cache=True)
        o2, st2, cv2 = mamba2.mamba_decode_step(p, _t(xd), cfg, tm.policy,
                                                st, cv)
    jout, (jst, jcv) = mamba_jit(jcfg, jm.policy)(jp, x)
    jo2, jst2, jcv2 = jax.jit(
        lambda pp, xx, s, c: jmamba.mamba_decode_step(
            pp, xx, jcfg, jm.policy, s, c))(jp, xd, jst, jcv)
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    assert tuple(st.shape) == np.shape(jst) == (2, H, P, N)
    assert tuple(cv.shape) == np.shape(jcv) == (2, 3, cfg.d_inner + 2 * N)
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
    if T < 3:
        assert not cv[:, :3 - T].any()
    np.testing.assert_array_equal(cv2.numpy(), np.asarray(jcv2))
    for a, b in ((out, jout), (st, jst), (o2, jo2), (st2, jst2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def mamba_jit(jcfg, jpol):
    return jax.jit(lambda pp, xx: jmamba.mamba_apply(
        pp, xx, jcfg, jpol, return_cache=True))


def _batch(seed=0, B=2, L=20):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (B, L)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, L)).astype(np.int32)}


def test_forward_loss_and_grads_equal_jax(pair):
    policy, (jm, params, tm) = pair
    batch = _batch()
    jl = jax.jit(lambda p, t: jm.forward(p, t)[0])(params, batch["tokens"])
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        tl = tm.forward(tb["tokens"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    loss, _ = tm.loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    names = [n for n, _ in tm.named_parameters()]
    assert any(n.endswith("mamba.A_log") for n in names)
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    for name, g in zip(names, grads):
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want[name] / scale,
                                   atol=GRAD_TOL, err_msg=name)


def test_prefill_decode_verify_and_chunks_equal_jax(mirage_pair):
    """``prefill`` at L = 19 (two chunks, the second padded), three
    ``decode_step``s, ``verify_step``'s per-token states, and the same
    prompt as chunks of 8, 8 and 3 through ``prefill_chunk`` into slot 1 of
    a stacked cache: against JAX's, and the chunked logits against the
    whole prompt's."""
    jm, params, tm = mirage_pair
    toks = _batch(seed=3, B=2, L=19)["tokens"]
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, t, 32))(params, toks)
    with torch.no_grad():
        log, cache = tm.prefill(_t(toks), 32)
    assert sorted(cache) == sorted(jcache) == ["conv", "idx", "ssm"]
    for k in cache:
        assert tuple(cache[k].shape) == np.shape(jcache[k]), k
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    jdec = jax.jit(jm.decode_step)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jc, c = jcache, cache
    for _ in range(3):
        jl2, jc = jdec(params, jc, nxt)
        with torch.no_grad():
            l2, c = tm.decode_step(c, _t(nxt))
        np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(c["ssm"].numpy(), np.asarray(jc["ssm"]),
                                   rtol=TOL, atol=TOL)
        nxt = np.asarray(jnp.argmax(jl2, -1)).astype(np.int32)
    # verify: 3 tokens per row from the prefill state
    vt = np.concatenate([np.asarray(jnp.argmax(jlog, -1)), toks[:, :2]],
                        axis=1).astype(np.int32)
    jspec = dict(jcache, idx=jnp.full((2,), 19, jnp.int32))
    jvl, _, jsteps = jax.jit(jm.verify_step)(params, jspec, vt)
    with torch.no_grad():
        _, cache = tm.prefill(_t(toks), 32)
        before = cache["ssm"].clone()
        vl, vc, steps = tm.verify_step(dict(cache, idx=torch.full(
            (2,), 19, dtype=torch.int32)), _t(vt))
    assert torch.equal(cache["ssm"], before)      # the live state untouched
    np.testing.assert_allclose(vl.numpy(), np.asarray(jvl), rtol=TOL,
                               atol=TOL)
    for k in ("ssm", "conv"):
        assert tuple(steps[k].shape) == np.shape(jsteps[k])
        np.testing.assert_allclose(steps[k].numpy(), np.asarray(jsteps[k]),
                                   rtol=TOL, atol=TOL)
        assert torch.equal(vc[k], steps[k][:, -1])
    # chunks of 8, 8 and 3 into slot 1 of a 2-slot stacked cache
    live = tm.init_cache(2, 32, per_slot_idx=True)
    jlive = jm.init_cache(2, 32, per_slot_idx=True)
    live["ssm"].fill_(7.0)                    # stale state of a reused slot
    jlive = dict(jlive, ssm=jlive["ssm"] + 7.0)
    jchunk = jax.jit(jm.prefill_chunk)
    for pos0, take in ((0, 8), (8, 8), (16, 3)):
        chunk = toks[1:2, pos0:pos0 + take]
        jcl, jlive = jchunk(params, jlive, chunk, 1, pos0, take)
        with torch.no_grad():
            cl, live = tm.prefill_chunk(live, _t(chunk), 1, pos0, take)
        np.testing.assert_allclose(cl.numpy(), np.asarray(jcl), rtol=TOL,
                                   atol=TOL)
    assert int(live["idx"][1]) == 19 and int(live["idx"][0]) == 0
    np.testing.assert_allclose(live["ssm"].numpy(), np.asarray(jlive["ssm"]),
                               rtol=TOL, atol=TOL)
    assert torch.all(live["ssm"][:, 0] == 7.0)
    np.testing.assert_allclose(cl[0, 0].numpy(), log[1, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_training_steps_and_checkpoint_equal_jax(tmp_path):
    """Two AdamW steps (lr 1e-3, clip 1.0) under ``mirage`` against JAX's
    train step; the port's checkpoint, in the JAX layout, read by the JAX
    checkpointer into a JAX template bit for bit, every ``mamba`` leaf and
    the untied ``lm_head`` included."""
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy("mirage"))
    jtc = JTrainConfig(policy=jpolicy("mirage"), optimizer="adamw", lr=1e-3)
    jstate = jtrainer.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).reduced(), get_policy("mirage"),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray,
                                               jstate["params"]))
    tc = TrainConfig(policy=get_policy("mirage"), optimizer="adamw", lr=1e-3)
    state = trainer.init_train_state(tm, tc)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    step = trainer.make_train_step(tm, tc)

    def source(module):
        return module.SyntheticLM(module.SyntheticLMConfig(
            vocab_size=cfg.vocab_size, seq_len=20, batch_size=2, seed=0))

    jdata, data = source(jpipeline), source(pipeline)
    for _ in range(2):
        jstate, jmet = jstep(jstate, next(jdata))
        state, met = step(state, next(data))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=GRAD_TOL)
    Checkpointer(str(tmp_path)).save(to_jax_train_state(tm, state), step=2)
    template = jax.tree_util.tree_map(np.zeros_like, jstate)
    got, _ = JCheckpointer(str(tmp_path)).restore(template, 2)
    flat = jflatten(got)
    assert any("mamba" in path and "A_log" in path for path in flat)
    assert any("lm_head" in path for path in flat)
    want = jflatten(jax.tree_util.tree_map(np.asarray,
                                           to_jax_train_state(tm, state)))
    assert sorted(flat) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(np.asarray(flat[path]), arr, path)
    # and the trained parameters stay within the loss's tolerance of JAX's
    jp = _by_name(tm, jax.tree_util.tree_map(np.asarray, jstate["params"]))
    for name, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), jp[name],
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
