"""PyTorch port, slice 6f: the hybrid family (zamba2-2.7b) against the JAX
package.

Reduced zamba2-2.7b (4 Mamba2 layers, d_model 64, 16 SSD heads of P = 8,
N = 16, chunk 16; the shared attention + MLP block after layers 1 and 3,
``attn_every = 2``: 2 applications of one set of weights, GQA 4/2 at
head_dim 16; untied head) takes the JAX init's weights in both packages
(``interop.load_jax_params`` maps ``shared.*`` by name).

- The LM: forward logits (fp32 and ``mirage``) within 1e-5, the loss and
  the gradient of every leaf, ``shared.*`` included (the block's gradient
  sums over its applications), within 1e-5 of each leaf's largest
  magnitude, ``A_log``'s excepted under fp32 (1e-4: it runs through the
  reordered SSD scan, as in ``tests/test_torch_mamba2.py``); ``remat``
  (the layer and its shared application one checkpointed unit) gives the
  same loss and gradients bit for bit.
- Serving: ``prefill`` then 3 ``decode_step``s on a dense cache and on a
  paged one (a permuted block table), ``verify_step``'s logits, per-token
  states and shared pools, and ``prefill_chunk`` over exact chunks into
  slot 1 of a paged cache, against JAX's within 1e-5.
- The shared block's stationary residues, bit for bit: clean, and with
  programming drift with JAX's draws fed in; the JAX tree carried over by
  ``load_jax_stationary``.
- ``health.suppressed()`` records nothing, and a decode step under an
  open scope counts the Mamba layers' and the head's GEMMs alone, as the
  JAX package's ``_cond_suppressed`` does.
- Two AdamW steps against JAX's train step (fp32), and the port's
  checkpoint in the JAX layout, ``shared`` subtree included, read by JAX
  bit for bit.
"""

import contextlib
import dataclasses

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
from repro.models import build_model as jbuild
from repro.models import lm as jlm
from repro.runtime import trainer as jtrainer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import gemm, stationary
from repro_torch.core.precision import get_policy
from repro_torch.data import pipeline
from repro_torch.interop import (_by_name, load_jax_params,
                                 load_jax_stationary, to_jax_train_state)
from repro_torch.models import build_model
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import health
from repro_torch.runtime import trainer

ARCH = "zamba2-2.7b"
TOL = 1e-5
SCAN_GRAD_TOL = 1e-4
CAP, BS = 32, 4


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


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _batch(seed=0, B=2, L=20):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (B, L)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, L)).astype(np.int32)}


def test_model_builds_the_shared_block(mirage_pair):
    jm, params, tm = mirage_pair
    cfg = tm.cfg
    assert tm.kind == "mamba" and tm.napp == 2 and cfg.attn_every == 2
    assert [tm._applies_shared(li) for li in range(4)] == [None, 0, None, 1]
    sp = tm.shared
    assert tuple(sp.proj.w.shape) == (2 * cfg.d_model, cfg.d_model)
    assert sp.attn.q.b is None and sp.attn.q_norm is None
    names = {n for n, _ in tm.named_parameters() if n.startswith("shared")}
    want = {"/".join(p.key for p in path).replace("/", ".")
            for path, _ in jax.tree_util.tree_flatten_with_path(
                params["shared"])[0]}
    assert names == {f"shared.{n}" for n in want}
    # the shared block belongs to the hybrid family alone
    with pytest.raises(ValueError, match="hybrid"):
        build_model(dataclasses.replace(cfg, family="ssm"),
                    get_policy("fp32"), device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        build_model(dataclasses.replace(cfg, attn_every=0),
                    get_policy("fp32"), device="cpu")


def test_forward_loss_and_grads_equal_jax(pair):
    policy, (jm, params, tm) = pair
    batch = _batch()
    jl = jax.jit(lambda p, t: jm.forward(p, t)[0])(params, batch["tokens"])
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        tl = tm.forward(tb["tokens"])
    _close(tl, jl)
    loss, _ = tm.loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    names = [n for n, _ in tm.named_parameters()]
    assert sum(n.startswith("shared.") for n in names) == 10
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    for name, g in zip(names, grads):
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        tol = SCAN_GRAD_TOL if policy == "fp32" and \
            name.endswith("A_log") else TOL
        np.testing.assert_allclose(g.numpy() / scale, want[name] / scale,
                                   atol=tol, err_msg=name)


def test_remat_checkpoints_the_layer_and_its_application(mirage_pair):
    """Under ``remat`` each layer and the shared application after it are
    one checkpointed unit with ``emb0`` among its inputs: the same loss
    and gradients, bit for bit, the embedding's included."""
    _, _, tm = mirage_pair
    remat = build_model(tm.cfg, tm.policy, LMCallOptions(remat=True),
                        device="cpu")
    remat.load_state_dict(tm.state_dict())
    tb = {k: _t(v) for k, v in _batch(seed=1).items()}
    out = []
    for m in (tm, remat):
        loss, _ = m.loss(tb)
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _paged(jm, tm, jcache, cache, L, seed=0):
    """Stacked 2-slot paged caches (a permuted table, blocks of 4) holding
    a dense prefill cache of both rows at length ``L``."""
    nb = 2 * CAP // BS
    table = np.random.default_rng(seed).permutation(nb).reshape(2, -1)
    jlive = jm.init_cache(2, CAP, per_slot_idx=True, layout="paged",
                          block_size=BS)
    live = tm.init_cache(2, CAP, per_slot_idx=True, layout="paged",
                         block_size=BS)
    assert sorted(live) == sorted(jlive) == [
        "bt", "conv", "idx", "shared_kp", "shared_vp", "ssm"]
    assert int(live["bt"][0, 0]) == nb
    jlive = dict(jlive, bt=jnp.asarray(table, jnp.int32))
    live["bt"].copy_(_t(table))
    slots = np.arange(2)
    jlive = jlm.cache_insert(jlive, dict(jcache, idx=jnp.full(
        (2,), L, jnp.int32)), jnp.asarray(slots))
    tlm.cache_insert(live, dict(cache, idx=torch.full((2,), L,
                                                      dtype=torch.int32)),
                     _t(slots))
    for k in ("shared_kp", "shared_vp", "ssm"):
        _close(live[k], jlive[k])
    return jlive, live


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_then_decode_equal_jax(mirage_pair, layout):
    """``prefill`` at L = 19 (the shared KV written at positions 0..18 of
    both applications), then 3 ``decode_step``s, each application's KV
    read and written through the dense rings or the paged pools."""
    jm, params, tm = mirage_pair
    toks = _batch(seed=3, B=2, L=19)["tokens"]
    jlog, jc = jax.jit(lambda p, t: jm.prefill(p, t, CAP))(params, toks)
    with torch.no_grad():
        log, c = tm.prefill(_t(toks), CAP)
    assert sorted(c) == sorted(jc) == [
        "conv", "idx", "shared_k", "shared_v", "ssm"]
    assert tuple(c["shared_k"].shape) == (2, 2, CAP, 2, 16)
    _close(log, jlog)
    for k in ("shared_k", "shared_v", "ssm", "conv"):
        _close(c[k], jc[k])
    if layout == "paged":
        jc, c = _paged(jm, tm, jc, c, 19)
    jdec = jax.jit(jm.decode_step)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):
        jl2, jc = jdec(params, jc, nxt)
        with torch.no_grad():
            l2, c = tm.decode_step(c, _t(nxt))
        _close(l2, jl2)
        nxt = np.asarray(jnp.argmax(jl2, -1)).astype(np.int32)
    keys = ("shared_kp", "shared_vp") if layout == "paged" else \
        ("shared_k", "shared_v")
    for k in keys + ("ssm", "conv", "idx"):
        _close(c[k], jc[k])


def test_verify_step_equals_jax(mirage_pair):
    """``verify_step`` over 3 tokens a slot of a paged cache: the logits,
    the per-token ``ssm``/``conv`` states (the live ones untouched) and
    the 3 tokens' KV in both applications' pools."""
    jm, params, tm = mirage_pair
    toks = _batch(seed=4, B=2, L=17)["tokens"]
    jlog, jc = jax.jit(lambda p, t: jm.prefill(p, t, CAP))(params, toks)
    with torch.no_grad():
        _, c = tm.prefill(_t(toks), CAP)
    jc, c = _paged(jm, tm, jc, c, 17, seed=1)
    vt = np.concatenate([np.asarray(jnp.argmax(jlog, -1)), toks[:, :2]],
                        axis=1).astype(np.int32)
    jvl, jvc, jsteps = jax.jit(jm.verify_step)(params, jc, vt)
    before = c["ssm"].clone()
    with torch.no_grad():
        vl, vc, steps = tm.verify_step(c, _t(vt))
    assert torch.equal(c["ssm"], before)
    assert int(c["idx"][0]) == 17
    _close(vl, jvl)
    for k in ("ssm", "conv"):
        assert tuple(steps[k].shape) == np.shape(jsteps[k])
        _close(steps[k], jsteps[k])
        assert torch.equal(vc[k], steps[k][:, -1])
    for k in ("shared_kp", "shared_vp"):
        _close(vc[k], jvc[k])


def test_prefill_chunk_equals_jax(mirage_pair):
    """The prompt as exact chunks of 8, 8 and 3 through ``prefill_chunk``
    into slot 1 of a paged cache (slot 0 mid-decode, a reused slot's stale
    state in slot 1), against JAX's; the last chunk's logits against the
    whole prompt's prefill."""
    jm, params, tm = mirage_pair
    toks = _batch(seed=5, B=2, L=19)["tokens"]
    jlive = jm.init_cache(2, CAP, per_slot_idx=True, layout="paged",
                          block_size=BS)
    live = tm.init_cache(2, CAP, per_slot_idx=True, layout="paged",
                         block_size=BS)
    table = np.random.default_rng(2).permutation(16).reshape(2, 8)
    jlive = dict(jlive, bt=jnp.asarray(table, jnp.int32),
                 ssm=jlive["ssm"] + 7.0)
    live["bt"].copy_(_t(table))
    live["ssm"].fill_(7.0)
    jchunk = jax.jit(jm.prefill_chunk)
    for pos0, take in ((0, 8), (8, 8), (16, 3)):
        chunk = toks[1:2, pos0:pos0 + take]
        jcl, jlive = jchunk(params, jlive, chunk, 1, pos0, take)
        with torch.no_grad():
            cl, live = tm.prefill_chunk(live, _t(chunk), 1, pos0, take)
        _close(cl, jcl)
    assert int(live["idx"][1]) == 19 and int(live["idx"][0]) == 0
    for k in ("ssm", "conv", "shared_kp", "shared_vp"):
        _close(live[k], jlive[k])
    assert torch.all(live["ssm"][:, 0] == 7.0)
    with torch.no_grad():
        whole, _ = tm.prefill(_t(toks[1:2]), CAP)
    np.testing.assert_allclose(cl[0, 0].numpy(), whole[0, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


class Replay:
    """Draws that replay the JAX package's for the same stage names."""

    def __init__(self, keys):
        self.keys = keys

    def normal(self, stage, shape):
        return _t(jax.random.normal(self.keys[stage], shape))

    def uniform(self, stage, shape):
        return _t(jax.random.uniform(self.keys[stage], shape))

    def randint(self, stage, shape, low, high):
        return _t(jax.random.randint(self.keys[stage], shape, low, high))


SHARED_DENSE = ("proj", "attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                "mlp.up", "mlp.down")


@pytest.mark.parametrize("kw", [{}, dict(phase_drift_sigma=0.6, dac_bits=5,
                                         noise_seed=11)])
def test_shared_stationary_residues_equal_jax(mirage_pair, kw):
    """Each of the shared block's 2-D weights is programmed once, under its
    own JAX path ``shared/<...>/w`` (not split per layer): bit for bit
    against JAX's ``encode_stationary_params``, clean by the port's own
    encoder, with drift by the port's encoder on JAX's draws for that
    path; the JAX tree carried over by ``load_jax_stationary``."""
    _, params, tm = mirage_pair
    jp, p = jpolicy("mirage_rrns", **kw), get_policy("mirage_rrns", **kw)
    enc = jax.jit(lambda t: jstationary.encode_stationary_params(t, jp))(
        params)
    carried = load_jax_stationary(tm, jax.tree_util.tree_map(np.asarray,
                                                             enc))
    ours = stationary.encode_stationary_params(tm, p) if not kw else None
    for name in SHARED_DENSE:
        key = f"shared.{name}"
        path = stationary.jax_path(key)
        assert path == f"shared/{name.replace('.', '/')}/w"
        node = enc
        for part in path.split("/"):
            node = node[part]
        if ours is not None:
            got = ours[key]
        else:
            got = stationary.encode_stationary(
                tm.get_submodule(key).w.detach(), p,
                draws=Replay({"drift": jstationary._leaf_key(jp, path)}))
        for sr in (got, carried[key]):
            np.testing.assert_array_equal(sr.residues.numpy(),
                                          np.asarray(node.residues))
            np.testing.assert_array_equal(sr.scale.numpy(),
                                          np.asarray(node.scale))
    if ours is not None:
        assert set(ours) == set(carried)


def test_health_suppressed_drops_the_shared_block(mirage_pair,
                                                  monkeypatch):
    """``suppressed()`` records nothing inside an open scope; a decode
    step under ``mirage_rrns`` at 40 dB records its decodes for the 2 x 4
    Mamba projections and the head alone (9 GEMMs), and the shared
    block's 8 GEMMs a application only once the scope is lifted."""
    with health.collect() as hc:
        health.record("x", torch.tensor(1))
        with health.suppressed():
            assert not health.active()
            health.record("x", torch.tensor(5))
        assert health.active()
        health.record("x", torch.tensor(2))
    assert int(hc.values["x"]) == 3 and not health.active()

    _, params, base = mirage_pair
    policy = get_policy("mirage_rrns", snr_db=40.0, noise_seed=7)
    tm = build_model(base.cfg, policy, device="cpu")
    tm.load_state_dict(base.state_dict())
    calls = []
    add = health.HealthCollector.add

    def spy(self, name, value):
        calls.append(name)
        add(self, name, value)

    monkeypatch.setattr(health.HealthCollector, "add", spy)
    toks = _t(_batch(seed=6, B=2, L=6)["tokens"])

    def decode_records():
        calls.clear()
        with torch.inference_mode():
            _, cache = tm.prefill(toks, CAP)
            gen = torch.Generator().manual_seed(0)
            with gemm.noise_scope(gen), health.collect() as hc:
                tm.decode_step(cache, toks[:, :1])
        return calls.count("rrns_uncorrected"), hc.values

    n, values = decode_records()
    assert n == 2 * 4 + 1 and int(values["rrns_corrected"]) > 0
    monkeypatch.setattr(tlm.obs_health, "suppressed",
                        contextlib.nullcontext)
    assert decode_records()[0] == 2 * 4 + 1 + 8 * tm.napp


def test_training_steps_and_checkpoint_equal_jax(tmp_path):
    """Two AdamW steps (lr 1e-3, clip 1.0) under ``fp32`` against JAX's
    train step; the port's checkpoint, in the JAX layout, read by the JAX
    checkpointer bit for bit, the ``shared`` subtree included.

    Under ``mirage`` the trainer's first batch gives a forward bit for bit
    equal to JAX's and cotangents within 2e-7 at every layer boundary, but
    the backward GEMMs round ``dO`` to 4-bit BFP mantissas, where those
    last-place differences (the SSD scan's reordered sums) flip roundings:
    the step's grad norm then differs by 3e-4 relative. The gradient test
    above holds ``mirage`` on its own batch."""
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
                                   float(jmet["grad_norm"]), rtol=TOL)
    Checkpointer(str(tmp_path)).save(to_jax_train_state(tm, state), step=2)
    template = jax.tree_util.tree_map(np.zeros_like, jstate)
    got, _ = JCheckpointer(str(tmp_path)).restore(template, 2)
    flat = jflatten(got)
    assert any("shared" in path and "proj" in path for path in flat)
    want = jflatten(jax.tree_util.tree_map(np.asarray,
                                           to_jax_train_state(tm, state)))
    assert sorted(flat) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(np.asarray(flat[path]), arr, path)
    jp = _by_name(tm, jax.tree_util.tree_map(np.asarray, jstate["params"]))
    for name, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), jp[name],
                                   rtol=SCAN_GRAD_TOL, atol=SCAN_GRAD_TOL,
                                   err_msg=name)
