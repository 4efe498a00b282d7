"""PyTorch port: checkpoints across the packages. The port writes the JAX
package's on-disk layout (``interop.to_jax_train_state``), so each package
reads the other's: a checkpoint JAX's ``Checkpointer`` wrote after one
step resumes in the port, whose next step equals JAX's (loss and grad
norm within 1e-5 under fp32); JAX's ``Checkpointer.restore`` reads the
port's into a JAX template bit for bit, with the JAX state's leaf paths
and dtypes."""

import json

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten as jflatten
from repro.configs import get_config as jconfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.precision import get_policy as jpolicy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import SyntheticLMConfig as JSyntheticLMConfig
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import trainer as jtrainer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.interop import (_by_name, load_jax_train_state,
                                 restore_train_state, to_jax_train_state)
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import trainer


@pytest.fixture(scope="module")
def jax_run():
    """The reduced model under fp32 (the quickstart's recipe at seq 32):
    JAX's state after one step and after two, the step's inputs, and the
    models of both packages."""
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy("fp32"), JOptions(q_chunk=16, kv_chunk=16))
    jtc = JTrainConfig(policy=jpolicy("fp32"), optimizer="adamw", lr=1e-3)
    jstate = jtrainer.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    data = JSyntheticLM(JSyntheticLMConfig(vocab_size=256, seq_len=32,
                                           batch_size=2))
    s1, _ = jstep(jstate, next(data))
    s2, m2 = jstep(s1, next(data))
    return {"cfg": cfg, "s1": s1, "s2": s2, "loss2": float(m2["loss"]),
            "grad_norm2": float(m2["grad_norm"]), "batch2": data.batch_at(1)}


def _port_fp32(cfg):
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    tm = build_model(ModelConfig(**fields), get_policy("fp32"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    tc = TrainConfig(policy=get_policy("fp32"), optimizer="adamw", lr=1e-3)
    return tm, tc


def test_port_resumes_a_jax_checkpoint(tmp_path, jax_run):
    JCheckpointer(str(tmp_path)).save(jax_run["s1"], step=1,
                                      metadata={"data": {"step": 1}})
    tm, tc = _port_fp32(jax_run["cfg"])
    state = trainer.init_train_state(tm, tc)
    state, meta = restore_train_state(Checkpointer(str(tmp_path)), tm, state)
    assert meta == {"data": {"step": 1}} and int(state["step"]) == 1
    assert int(state["opt"]["count"]) == 1
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray,
                                               jax_run["s1"]["opt"]["v"]))
    for n, arr in want.items():
        np.testing.assert_array_equal(state["opt"]["v"][n].numpy(), arr)
    state, met = trainer.make_train_step(tm, tc)(state, jax_run["batch2"])
    np.testing.assert_allclose(float(met["loss"]), jax_run["loss2"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               jax_run["grad_norm2"], rtol=1e-5)
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray,
                                               jax_run["s2"]["params"]))
    for n, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=1e-5, err_msg=n)


def test_jax_restores_a_port_checkpoint(tmp_path, jax_run):
    """JAX's ``Checkpointer.restore`` reads the port's checkpoint into a
    JAX template: the same leaf paths, dtypes and values, bit for bit."""
    tm, tc = _port_fp32(jax_run["cfg"])
    jnp_s1 = jax.tree_util.tree_map(np.asarray, jax_run["s1"])
    state = load_jax_train_state(tm, jnp_s1, tc)
    state["params"]["embed.emb"].data.mul_(0.5)   # the port's own values
    Checkpointer(str(tmp_path)).save(to_jax_train_state(tm, state), step=1)
    manifest = json.loads(
        (tmp_path / "step_0000000001" / "manifest.json").read_text())
    assert list(manifest["leaves"]) == list(jflatten(jnp_s1))
    restored, _ = JCheckpointer(str(tmp_path)).restore(jax_run["s1"])
    jflat, want = jflatten(restored), jflatten(to_jax_train_state(tm, state))
    for path, arr in want.items():
        got = np.asarray(jflat[path])
        assert got.dtype == arr.dtype, path
        np.testing.assert_array_equal(got, arr, err_msg=path)
    emb = np.asarray(restored["params"]["embed"]["emb"])
    np.testing.assert_array_equal(emb, state["params"]["embed.emb"]
                                  .detach().numpy())
    np.testing.assert_array_equal(emb, 0.5 * jnp_s1["params"]["embed"]["emb"])
