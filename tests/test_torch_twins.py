"""PyTorch port: the twins of ``examples/quickstart.py`` and
``examples/mirage_vs_fp32.py`` (``python -m repro_torch.examples.*``)
against the JAX scripts.

The exact sections print the same lines as the JAX script: RNS exactness,
the BFP GEMM error per b_m, and the analog-channel rows (under the JAX
package's replayed draws). The training runs start from the JAX package's
weights and run at most 3 steps: step 1 within the training contract
(``tests/test_torch_train.py``: 1e-5 under fp32, 1e-6 under mirage), then
both packages learn."""

import importlib.util
import os
import re

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.precision import get_policy as jpolicy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import SyntheticLMConfig as JSyntheticLMConfig
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import trainer as jtrainer
from repro_torch.examples import mirage_vs_fp32, quickstart
from repro_torch.interop import load_jax_params
from test_torch_sweep import _replay

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's weights and its losses on the twins' recipe
    (reduced qwen2-0.5b, seq 48, batch 4, AdamW lr 1e-3): 3 steps under
    mirage (the quickstart), then the first batch's loss; 1 under fp32."""
    cfg = jconfig("qwen2-0.5b").reduced()
    out = {}
    for name, steps in (("fp32", 1), ("mirage", 3)):
        jm = jbuild(cfg, jpolicy(name), JOptions(q_chunk=32, kv_chunk=32))
        tc = JTrainConfig(policy=jpolicy(name), optimizer="adamw", lr=1e-3)
        state = jtrainer.init_train_state(jm, tc, jax.random.PRNGKey(0))
        out["params"] = jax.tree_util.tree_map(np.asarray, state["params"])
        step = jax.jit(jtrainer.make_train_step(jm, tc))
        data = JSyntheticLM(JSyntheticLMConfig(vocab_size=cfg.vocab_size,
                                               seq_len=48, batch_size=4))
        losses = []
        for _ in range(steps):
            state, met = step(state, next(data))
            losses.append(float(met["loss"]))
        out[name] = losses
    # after the mirage steps: the loss on the first batch, which fell
    out["first_batch_after"] = float(jax.jit(jm.loss)(
        state["params"], data.batch_at(0))[0])
    return out


def _lines(capsys, fn, *args, **kw):
    capsys.readouterr()
    fn(*args, **kw)
    return capsys.readouterr().out.splitlines()


def test_exact_sections_print_the_jax_lines(capsys):
    jscript = _jax_script("mirage_vs_fp32")
    for name in ("rns_exactness", "gemm_error"):
        want = _lines(capsys, getattr(jscript, name))
        got = _lines(capsys, getattr(mirage_vs_fp32, name), device="cpu")
        assert got == want and len(want) > 1
    assert "exact: True" in got[0] or "exact: True" in " ".join(
        _lines(capsys, mirage_vs_fp32.rns_exactness, device="cpu"))


def test_noise_section_prints_the_jax_lines(capsys):
    jscript = _jax_script("mirage_vs_fp32")
    want = _lines(capsys, jscript.noise_recovery, 45.0, True)
    got = _lines(capsys, mirage_vs_fp32.noise_recovery, 45.0, True,
                 device="cpu", draws=_replay(4))
    assert got == want


def test_training_parity_step_one(capsys, jax_runs):
    load = lambda m: load_jax_params(m, jax_runs["params"])  # noqa: E731
    res = mirage_vs_fp32.training_parity(steps=1, device="cpu", init=load)
    np.testing.assert_allclose(res["fp32"], jax_runs["fp32"][0], rtol=1e-5)
    np.testing.assert_allclose(res["mirage"], jax_runs["mirage"][0],
                               rtol=1e-6)
    assert all(np.isfinite(v) for v in res.values())
    out = capsys.readouterr().out
    assert "Mirage-FP32 gap" in out and "INT8-FP32 gap" in out


def test_quickstart_step_one_then_both_learn(capsys, jax_runs):
    """Step 1's printed loss is JAX's; after 3 steps the loss of the first
    batch has fallen in both packages (3 steps' own losses are on other
    batches and need not fall)."""
    load = lambda m: load_jax_params(m, jax_runs["params"])  # noqa: E731
    model, met = quickstart.run(device="cpu", steps=3, log_every=1,
                                init=load)
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"step \d+: loss=([\d.]+)", out)]
    assert len(losses) == 3 and out.startswith("policy: mirage_fast b_m=4")
    assert "final loss" in out and float(met["loss"]) == pytest.approx(
        losses[-1], abs=1e-4)
    np.testing.assert_allclose(losses[0], jax_runs["mirage"][0], atol=1e-4)
    batch0 = JSyntheticLM(JSyntheticLMConfig(vocab_size=256, seq_len=48,
                                             batch_size=4)).batch_at(0)
    with torch.no_grad():
        after = float(model.loss({k: torch.from_numpy(v)
                                  for k, v in batch0.items()})[0])
    assert after < jax_runs["mirage"][0]
    assert jax_runs["first_batch_after"] < jax_runs["mirage"][0]
