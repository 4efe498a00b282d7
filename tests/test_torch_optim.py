"""PyTorch port, slice 2: optimizers, clipping, schedules, gradient
compression and the data pipeline against the JAX package.

Numpy-seeded trees of a few leaves go through both. Optimizers, clipping
and schedules: allclose within 1e-6 (the same f32 formulas, summed in
other orders). Gradient compression (BFP quantization with error feedback)
and ``SyntheticLM`` batches: bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipeline
from repro.optim import grad_compress as jgc
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as tpipeline
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

SHAPES = {"a.w": (7, 33), "b.scale": (40,), "c.w": (3, 5, 16), "d": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.normal(size=s) * scale, dtype=np.float32)
            for k, s in SHAPES.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _close_tree(got, want, tol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_train_config_matches_jax():
    """Field for field, less the two that no trainer reads."""
    fields = set(TrainConfig.__dataclass_fields__)
    assert set(JTrainConfig.__dataclass_fields__) - fields == {"remat",
                                                                 "zero1"}
    for f in fields - {"policy"}:
        assert getattr(JTrainConfig(), f) == getattr(TrainConfig(), f), f
    assert TrainConfig().policy.mode == JTrainConfig().policy.mode


@pytest.mark.parametrize("optimizer,wd", [("adamw", 0.0), ("adamw", 0.1),
                                          ("adam", 0.1), ("sgdm", 0.0),
                                          ("sgdm", 0.05)])
def test_optimizer_steps_match_jax(optimizer, wd):
    """Five updates with a varying learning rate from the same params and
    gradients; the port updates in place."""
    cfg = dict(optimizer=optimizer, weight_decay=wd, beta1=0.8, beta2=0.99,
               momentum=0.7)
    j_init, j_upd = jopt.make_optimizer(JTrainConfig(**cfg))
    t_init, t_upd = topt.make_optimizer(TrainConfig(**cfg))
    jp, tp = _j(_tree(0)), _t(_tree(0))
    js, ts = j_init(jp), t_init(tp)
    for i in range(5):
        g = _tree(10 + i, 0.3)
        lr = 1e-2 / (1 + i)
        jp, js = j_upd(_j(g), js, jp, jnp.float32(lr))
        tp2, ts = t_upd(_t(g), ts, tp, torch.tensor(lr))
        assert tp2 is tp
    _close_tree(tp, jp)
    for key, val in js.items():
        if isinstance(val, dict):
            _close_tree(ts[key], val)
        else:
            assert int(ts[key]) == int(val)


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm"])
def test_update_groups_keep_every_bit(monkeypatch, optimizer):
    """The update runs over groups of leaves of at most UPDATE_GROUP_BYTES
    (its temporaries stay small at a 3 B-parameter model); one leaf a
    group gives the same bits as one group of every leaf."""
    cfg = TrainConfig(optimizer=optimizer, weight_decay=0.1)
    out = []
    for group_bytes in (1 << 30, 1):
        monkeypatch.setattr(topt, "UPDATE_GROUP_BYTES", group_bytes)
        t_init, t_upd = topt.make_optimizer(cfg)
        tp = _t(_tree(0))
        ts = t_init(tp)
        for i in range(3):
            t_upd(_t(_tree(10 + i, 0.3)), ts, tp, torch.tensor(1e-2))
        out.append(tp)
    assert len(list(topt._groups(out[1]))) == len(SHAPES)
    for k in SHAPES:
        assert torch.equal(out[0][k], out[1][k]), k


def test_global_norm_and_clip_match_jax():
    g = _tree(1, 2.0)
    want_n = float(jopt.global_norm(_j(g)))
    assert float(topt.global_norm(_t(g))) == pytest.approx(want_n, rel=1e-6)
    for max_norm in (1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm(_j(g), max_norm)
        tc, tn = topt.clip_by_global_norm(_t(g), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        _close_tree(tc, jc)


def test_global_norm_holds_on_a_large_leaf():
    """A leaf of 10 M elements (the tied embedding's gradient at full width
    has 136 M): the norm within 1e-6 of the f64 sum, on the CPU too, where
    an f32 norm sums serially and loses ~4e-4."""
    rng = np.random.default_rng(3)
    big = (rng.normal(size=10_000_000) * 1e-3).astype(np.float32)
    tree = {"emb": torch.from_numpy(big), "b": torch.ones(3)}
    exact = np.sqrt(np.sum(big.astype(np.float64) ** 2) + 3.0)
    assert float(topt.global_norm(tree)) == pytest.approx(exact, rel=1e-6)


@pytest.mark.parametrize("name,args", [
    ("step_decay", (0.1, 3)), ("step_decay", (1e-3, 5, 0.5)),
    ("warmup_cosine", (1e-3, 4, 20)), ("warmup_cosine", (1e-2, 0, 10, 0.0)),
    ("constant", (3e-4,))])
def test_schedules_match_jax(name, args):
    jfn, tfn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 25):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("b_m,g", [(4, 16), (3, 8)])
def test_error_feedback_bitwise_over_steps(b_m, g):
    jerr = jgc.init_error_buffer(_j(_tree(0)))
    terr = tgc.init_error_buffer(_t(_tree(0)))
    for i in range(4):
        grads = _tree(20 + i, 1e-2)
        jq, jerr = jgc.compress_with_error_feedback(_j(grads), jerr, b_m, g)
        tq, terr = tgc.compress_with_error_feedback(_t(grads), terr, b_m, g)
        for k in grads:
            for a, b in ((tq[k], jq[k]), (terr[k], jerr[k])):
                np.testing.assert_array_equal(
                    a.numpy().view(np.int32),
                    np.asarray(b).view(np.int32), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=48, batch_size=4),
    dict(vocab_size=151936, seq_len=64, batch_size=4, seed=3),
    dict(vocab_size=100, seq_len=9, batch_size=3, shard_id=1, num_shards=2,
         markov_order=False)])
def test_synthetic_lm_batches_bitwise(kw):
    jd = jpipeline.SyntheticLM(jpipeline.SyntheticLMConfig(**kw))
    td = tpipeline.SyntheticLM(tpipeline.SyntheticLMConfig(**kw))
    for _ in range(3):
        a, b = next(jd), next(td)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert td.state() == jd.state()
