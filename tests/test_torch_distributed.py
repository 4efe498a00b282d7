"""The port's sharded training on the CPU over gloo, held to the
single-device port (which ``tests/test_torch_train.py`` holds to JAX).

One module-scoped fixture starts the 4 ranks of a 2x2 (data, model) mesh
once (``tests/_torch_dist_ranks.py``, ~10 s) and every check reads what they
wrote: the train step under mirage (params within 5e-5, loss within 1e-5,
as ``tests/test_multidevice.py``'s JAX twin), with BFP gradient compression
and with weight-stationary quantization; the sharded decode step of reduced
mixtral (logits within 5e-4); data-parallel ``moe_apply`` with binding
capacity, and ``moe_apply_ep`` dropless and per data shard; the 2x2
checkpoint restored onto 1x4 and 1x1 bit for bit and read by the JAX
``Checkpointer``. A second fixture runs ``launch.train --distributed`` as 2
ranks and holds it to one process on the concatenated batch.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import _torch_dist_ranks as ranks  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import get_policy  # noqa: E402
from repro_torch.interop import (_by_name, restore_train_state,  # noqa: E402
                                 to_jax_train_state)
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import shard  # noqa: E402
from repro_torch.runtime.trainer import (init_train_state,  # noqa: E402
                                         make_train_step)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_dist_ranks.py"),
         str(out)], env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]

    def load(name):
        return torch.load(os.path.join(out, name), weights_only=False)
    return SimpleNamespace(dir=str(out), load=load)


VARIANTS = ("mirage", "bfp", "wsq", "merged")


def _jax_step(variant, model, jstate, batch):
    """The JAX package's step of ``variant`` on a JAX train state (the
    port's, through ``interop``) and the same batch, jitted: its new state,
    its metrics and its gradients (before compression and clipping), the
    trees keyed by the port's names."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jconfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core.precision import get_policy as jpolicy
    from repro.models import build_model as jbuild
    from repro.models.lm import LMCallOptions as JOptions
    from repro.runtime import trainer as jtrainer

    arch = "command-r-plus-104b" if variant == "merged" else "qwen2-0.5b"
    opt = {"merge_parallel_proj": True} if variant == "merged" else {}
    wsq = variant == "wsq"
    jp = jpolicy("mirage", assume_quantized_weights=wsq)
    jtc = JTrainConfig(policy=jp, lr=1e-3, weight_stationary_quant=wsq,
                       grad_compression="bfp" if variant == "bfp" else "none")
    jm = jbuild(jconfig(arch).reduced(), jp,
                JOptions(q_chunk=16, kv_chunk=16, **opt))
    jstep = jtrainer.make_train_step(jm, jtc)

    def both(state, b):
        # the step's own gradients: of the weight-stationary copies where
        # it takes them, as the step does
        params = jtrainer._prequantize_params(
            state["params"], jp, jnp.float32) if wsq else state["params"]
        _, g = jax.value_and_grad(jm.loss, has_aux=True)(params, b)
        return jstep(state, b), g
    (new, met), grads = jax.jit(both)(
        jax.tree_util.tree_map(jnp.asarray, jstate),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return SimpleNamespace(
        params=_by_name(model, jax.tree_util.tree_map(np.asarray,
                                                      new["params"])),
        metrics={k: float(v) for k, v in met.items()},
        grads=_by_name(model, jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def single():
    """The single-device port's steps on the global batch, and JAX's step
    on the same initial state and batch."""
    out = {}
    for variant in VARIANTS:
        cfg, opt = ranks.merged_arch() if variant == "merged" else (
            ranks.qwen2(), {})
        tc = ranks.train_config(variant)
        model = ranks.build(cfg, tc.policy, **opt)
        step = make_train_step(model, tc)
        state = init_train_state(model, tc)
        batch = ranks.train_batch(cfg)
        # a copy: the port's step updates its state in place
        jax_ref = _jax_step(variant, model, to_jax_train_state(model, state),
                            batch)
        with ranks.GradTap() as tap:
            state, metrics = step(state, batch)
        out[variant] = SimpleNamespace(model=model, state=state,
                                       metrics=metrics, grads=tap.grads,
                                       jax=jax_ref)
    return out


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("variant", VARIANTS)
def test_single_device_step_matches_jax(single, variant):
    """The single-device step that the 2x2 step is held to, held to JAX's
    step on the same initial state and batch at ``test_torch_train``'s
    step-one bounds: the loss and grad norm within 1e-6 relative, every
    gradient leaf within 1e-4 of its largest element, every updated
    parameter within 1e-5 (1% of one AdamW update)."""
    got, want = single[variant], single[variant].jax
    np.testing.assert_allclose(float(got.metrics["loss"]),
                               want.metrics["loss"], rtol=1e-6)
    np.testing.assert_allclose(float(got.metrics["grad_norm"]),
                               want.metrics["grad_norm"], rtol=1e-6)
    for n, g in got.grads.items():
        scale = float(np.abs(want.grads[n]).max()) + 1e-30
        assert float(np.abs(g.numpy() - want.grads[n]).max()) <= \
            1e-4 * scale + 1e-8, n
    for n, p in got.state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want.params[n],
                                   rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_2x2_matches_single_device(dist_run, single, variant):
    """One step on the 2x2 mesh == the same step on one device: params
    within 5e-5, loss within 1e-5 (``test_multidevice.py``'s bounds).
    ``merged``: reduced command-r with ``merge_parallel_proj``, whose
    parallel block's o and down run as one row-parallel GEMM."""
    got = dist_run.load(f"train_{variant}_0.pt")
    want = single[variant]
    assert abs(float(got["loss"]) - float(want.metrics["loss"])) < 1e-5
    assert _max_diff(want.state["params"], got["state"]["params"]) < 5e-5
    assert abs(float(got["grad_norm"]) - float(want.metrics["grad_norm"])) \
        < 1e-5 * float(want.metrics["grad_norm"])
    if variant == "bfp":
        # the error-feedback buffer shards like its parameter and holds
        # the reduced gradient's residual
        assert _max_diff(want.state["err"], got["state"]["err"]) < 1e-6


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_2x2_gradients(dist_run, single, variant):
    """Every gradient leaf, summed over the data ranks, within 1e-5
    relative L2 of the single-device gradient."""
    got = dist_run.load(f"train_{variant}_0.pt")["grads"]
    for k, g in single[variant].grads.items():
        rel = float((got[k] - g).norm() / g.norm().clamp_min(1e-30))
        assert rel < 1e-5, (k, rel)


def test_train_state_placed_by_the_rules(dist_run, single):
    """Every rank gathers the same whole state, and each rank's shards are
    the JAX rules' (qwen2's q: (fsdp, tp) -> (32, 32) of (64, 64))."""
    a = dist_run.load("train_mirage_0.pt")["state"]
    for r in (1, 2, 3):
        b = dist_run.load(f"train_mirage_{r}.pt")["state"]
        assert _max_diff(a["params"], b["params"]) == 0.0
        assert _max_diff(a["opt"]["m"], b["opt"]["m"]) == 0.0


def test_tp_gemms_read_the_local_shard(dist_run):
    """The GEMMs of a TP-sharded weight read N/2 (column: q/k/v, gate/up,
    the tied head) or K/2 (row: o, down), never the whole weight; and each
    rank runs as many GEMMs as one device (3 per forward GEMM)."""
    cfg = ranks.qwen2()
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    qn, kn = cfg.n_heads * hd, cfg.n_kv_heads * hd
    layer = [(d, qn // 2), (d, kn // 2), (d, kn // 2), (qn // 2, d),
             (d, f // 2), (d, f // 2), (f // 2, d)]
    want = layer * cfg.n_layers + [(d, cfg.vocab_size // 2)]
    for r in range(4):
        shapes = dist_run.load(f"train_mirage_{r}.pt")["shapes"]
        # the forward's GEMMs come first, in the layers' order
        assert [(k, n) for _, k, n in shapes[:len(want)]] == want
        assert len(shapes) == 3 * (7 * cfg.n_layers + 1)


@pytest.fixture(scope="module")
def decode_single():
    """Reduced mixtral's prefill and one decode step on one device, as the
    ranks run them, and JAX's on the same weights and tokens (jitted)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jconfig
    from repro.core.precision import get_policy as jpolicy
    from repro.models import build_model as jbuild
    from repro.models.lm import LMCallOptions as JOptions
    from repro_torch.interop import _jax_layout

    cfg = get_config("mixtral-8x7b").reduced()
    model = ranks.build(cfg, get_policy("mirage"))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int64)
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(toks), 16)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1)
        want, _ = model.decode_step(cache, nxt)
    jm = jbuild(jconfig("mixtral-8x7b").reduced(), jpolicy("mirage"),
                JOptions(q_chunk=16, kv_chunk=16))
    params = _jax_layout(model, dict(model.named_parameters()),
                         lambda t: jnp.asarray(t.detach().numpy()),
                         jnp.stack)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, jnp.asarray(toks.astype(np.int32)), 16)
    jnxt = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32)
    jl2, _ = jax.jit(jm.decode_step)(params, jc, jnxt)
    return SimpleNamespace(logits=logits, nxt=nxt, step=want,
                           jax_logits=np.asarray(jl),
                           jax_nxt=np.asarray(jnxt), jax_step=np.asarray(jl2))


def test_decode_step_sharded_matches_single(dist_run, decode_single):
    """Reduced mixtral's decode step with params and cache sharded by the
    rules (kv heads over model, rows over data) == one device within 5e-4
    (``test_multidevice.py``'s bound)."""
    parts = [dist_run.load(f"decode_{r}.pt") for r in range(4)]
    got = torch.cat([parts[0]["logits"], parts[2]["logits"]])
    assert torch.equal(parts[0]["logits"], parts[1]["logits"])
    assert parts[0]["cache_k"][1] == 1 and parts[0]["cache_k"][3] == 1
    assert float((got - decode_single.step).abs().max()) < 5e-4


def test_decode_step_single_matches_jax(decode_single):
    """The one-device prefill and decode step that the sharded step is held
    to, held to JAX's on the same weights and tokens at
    ``test_torch_model``'s mirage bound (1e-4), with the same next
    tokens."""
    d = decode_single
    np.testing.assert_allclose(d.logits.numpy(), d.jax_logits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(d.nxt.numpy(), d.jax_nxt)
    np.testing.assert_allclose(d.step.numpy(), d.jax_step, rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def moe_single():
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              n_layers=1)
    model = ranks.build(cfg, get_policy("mirage"))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model))
                         .astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model))
                         .astype(np.float32))
    layer = model.layers[0].moe
    names = [f"layers.0.moe.{k}" for k in ("router.w", "gate", "up", "down")]

    def run(xx, rr, factor):
        xx = xx.clone().requires_grad_(True)
        y, aux = moe.moe_apply(layer, xx, get_policy("mirage"),
                               n_experts=cfg.n_experts,
                               experts_per_token=cfg.experts_per_token,
                               capacity_factor=factor)
        g = torch.autograd.grad(torch.sum(y * rr) + aux,
                                [model.get_parameter(k) for k in names]
                                + [xx])
        return SimpleNamespace(y=y.detach(), aux=aux.detach(),
                               grads=dict(zip(names, g[:-1])), dx=g[-1])

    def dropped(xx, factor):
        T = xx.shape[0] * xx.shape[1]
        C = moe.capacity(T, cfg.n_experts, cfg.experts_per_token, factor)
        with torch.no_grad():
            rt = moe.route(layer.router, xx.reshape(T, -1),
                           cfg.experts_per_token, C)
        return int((~rt.keep).sum())
    return SimpleNamespace(x=x, r=r, run=run, dropped=dropped)


def _rows(dist_run, name, key):
    parts = [dist_run.load(f"{name}_{r}.pt") for r in (0, 2)]
    return torch.cat([p[key] for p in parts])


def test_moe_dp_binding_capacity_matches_single(dist_run, moe_single):
    """Data-parallel ``moe_apply`` (global capacity and positions) with
    tokens dropped == one device on the whole batch: the outputs, the aux
    loss and the x gradient bit for bit, the expert gradients bit for bit
    and the router's within f32 order."""
    assert moe_single.dropped(moe_single.x, 1.25) > 0
    want = moe_single.run(moe_single.x, moe_single.r, 1.25)
    got0 = dist_run.load("moe_dp_1.25_0.pt")
    assert torch.equal(_rows(dist_run, "moe_dp_1.25", "y"), want.y)
    assert torch.equal(_rows(dist_run, "moe_dp_1.25", "dx"), want.dx)
    assert abs(float(got0["aux"]) - float(want.aux)) < 1e-6
    for k, g in want.grads.items():
        rel = float((got0["grads"][k] - g).norm() / g.norm())
        assert rel < (1e-6 if k.endswith("router.w") else 0.0) + 1e-12, \
            (k, rel)


def test_moe_ep_dropless_matches_moe_apply(dist_run, moe_single):
    """``moe_apply_ep`` dropless (capacity factor 8) == the single-device
    ``moe_apply`` on the whole batch; aux from the global means within
    1e-5."""
    assert moe_single.dropped(moe_single.x[:2], 8.0) == 0
    want = moe_single.run(moe_single.x, moe_single.r, 8.0)
    got = _rows(dist_run, "moe_ep_8.0", "y")
    assert float((got - want.y).abs().max()) < 1e-5
    assert abs(float(dist_run.load("moe_ep_8.0_0.pt")["aux"])
               - float(want.aux)) < 1e-5


def test_moe_ep_dropping_matches_moe_apply_per_shard(dist_run, moe_single):
    """With tokens dropped (factor 1.25, C from the local token count)
    ``moe_apply_ep`` == ``moe_apply`` on each data shard alone; its aux
    still takes the global means."""
    x, r = moe_single.x, moe_single.r
    for dr, rank in ((0, 0), (1, 2)):
        rows = slice(2 * dr, 2 * dr + 2)
        assert moe_single.dropped(x[rows], 1.25) > 0
        want = moe_single.run(x[rows], r[rows], 1.25)
        got = dist_run.load(f"moe_ep_1.25_{rank}.pt")
        assert float((got["y"] - want.y).abs().max()) < 1e-5
    full = moe_single.run(x, r, 1.25)
    assert abs(float(got["aux"]) - float(full.aux)) < 1e-5


def test_moe_ep_gradients_flow(dist_run):
    """Gradients reach the router, every expert stack and x through the
    expert-parallel path, finite and non-zero."""
    for f in ("8.0", "1.25"):
        got = dist_run.load(f"moe_ep_{f}_0.pt")
        for k, g in got["grads"].items():
            assert torch.isfinite(g).all() and float(g.norm()) > 0, k
        assert float(got["dx"].norm()) > 0


def test_elastic_restore_2x2_to_1x4_to_1x1(dist_run):
    """The train state saved under 2x2 restores onto 1x4 (every rank its
    (1, 4) shards) and onto one device bit for bit: ELASTIC_DIFF 0.0."""
    saved = dist_run.load("train_mirage_0.pt")["state"]
    e = dist_run.load("elastic_0.pt")
    assert e["local_shapes"]["layers.0.attn.q.w"] == (64, 16)
    for tree in ("params", "err"):
        if tree in saved:
            assert _max_diff(saved[tree], e["state"][tree]) == 0.0
    for k in ("m", "v"):
        assert _max_diff(saved["opt"][k], e["state"]["opt"][k]) == 0.0
    cfg = ranks.qwen2()
    tc = ranks.train_config("mirage")
    model = ranks.build(cfg, tc.policy)
    state = init_train_state(model, tc)
    state, _ = restore_train_state(
        Checkpointer(os.path.join(dist_run.dir, "ckpt")), model, state)
    diff = max(_max_diff(saved["params"], state["params"]),
               _max_diff(saved["opt"]["m"], state["opt"]["m"]),
               _max_diff(saved["opt"]["v"], state["opt"]["v"]))
    print("ELASTIC_DIFF", diff)
    assert diff == 0.0 and int(state["step"]) == 1


def test_jax_reads_the_sharded_checkpoint(dist_run):
    """JAX's ``Checkpointer`` reads the 2x2 run's checkpoint against the
    JAX train state's layout, leaf for leaf equal to the gathered state."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.checkpoint.checkpointer import _flatten as jflatten
    from repro.configs import get_config as jconfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core.precision import get_policy as jpolicy
    from repro.models import build_model as jbuild
    from repro.models.lm import LMCallOptions as JOptions
    from repro.runtime.trainer import abstract_train_state

    jcfg = jconfig("qwen2-0.5b").reduced()
    tmpl = abstract_train_state(jbuild(jcfg, jpolicy("mirage"),
                                       JOptions(q_chunk=16, kv_chunk=16)),
                                JTrainConfig(policy=jpolicy("mirage")))
    restored, _ = JCheckpointer(os.path.join(dist_run.dir, "ckpt")).restore(
        tmpl, step=1)
    jflat = jflatten(restored)
    want = jflatten(jax.tree_util.tree_map(np.asarray, tmpl))
    assert set(jflat) == set(want)
    saved = dist_run.load("train_mirage_0.pt")["state"]
    emb = np.asarray(jflat["params/embed/emb"])
    assert np.array_equal(emb, saved["params"]["embed.emb"].numpy())
    q = np.asarray(jflat["params/layers/attn/q/w"])
    assert q.shape == (jcfg.n_layers, jcfg.d_model,
                       jcfg.n_heads * jcfg.resolved_head_dim)
    assert np.array_equal(q[1], saved["params"]["layers.1.attn.q.w"].numpy())


def test_bfp_group_cut_is_refused():
    """A shard whose extent along a BFP-grouped dim is not a multiple of g
    raises instead of quantizing across the cut."""
    comm = SimpleNamespace(sizes={"data": 1, "model": 2}, coord={},
                           mesh=SimpleNamespace(size=lambda: 2))
    pl = shard.Placement(comm, (None, "model"), (64, 24))
    model = SimpleNamespace(placements={"layers.0.mlp.up.w": pl})
    with pytest.raises(ValueError, match="cuts BFP groups"):
        shard.check_bfp_groups(model, get_policy("mirage"))
    shard.check_bfp_groups(model, get_policy("fp32"))
    ok = shard.Placement(comm, (None, "model"), (64, 64))
    shard.check_bfp_groups(SimpleNamespace(placements={"a.w": ok}),
                           get_policy("mirage"))


def test_launcher_refuses_ranks_sharing_a_card(monkeypatch):
    """Under NCCL, a LOCAL_RANK past the host's cards (two ranks on one
    card) raises a clear error."""
    from repro_torch.launch import train

    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="two ranks would share"):
        train._distributed_device(None)
    assert train._distributed_device("cpu") == (torch.device("cpu"), "gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launcher_run(tmp_path_factory):
    """``launch.train --distributed --device cpu`` as 2 torchrun-style
    ranks, one step, checkpointed."""
    d = tmp_path_factory.mktemp("launch")
    env = _env()
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--distributed", "--device", "cpu", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(d),
            "--ckpt-every", "1"]
    procs = [subprocess.Popen(args, env=dict(env, RANK=str(r),
                                             LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    return SimpleNamespace(dir=str(d), stdout=[o for o, _ in outs])


def test_distributed_launcher_matches_one_process(launcher_run):
    """Two ranks of ``--distributed`` (each its SyntheticLM shard of 2 rows)
    train the one model of the concatenated batch: the checkpoint equals
    one process's step on it (params within 5e-5)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.models import build_model
    from repro_torch.models.lm import LMCallOptions

    cfg = get_config("qwen2-0.5b").reduced()
    policy = get_policy("mirage")
    tc = TrainConfig(policy=policy, lr=1e-3)
    batches = [SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=0,
        shard_id=r, num_shards=2)).batch_at(0) for r in range(2)]
    batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}

    def fresh():
        return build_model(cfg, policy, LMCallOptions(q_chunk=64,
                                                      kv_chunk=64),
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
    model = fresh()
    state = init_train_state(model, tc)
    state, metrics = make_train_step(model, tc)(state, batch)
    got_model = fresh()
    got = init_train_state(got_model, tc)
    got, _ = restore_train_state(Checkpointer(launcher_run.dir), got_model,
                                 got)
    assert int(got["step"]) == 1
    assert _max_diff(state["params"], got["params"]) < 5e-5
    assert f"final loss {float(metrics['loss']):.4f}" in \
        launcher_run.stdout[0]
