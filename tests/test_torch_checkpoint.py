"""PyTorch port: checkpoint and resume (``repro_torch.checkpoint``,
``runtime.elastic``, ``interop.to_jax_train_state`` and the launcher's
``--ckpt-dir/--resume``): ``tests/test_checkpoint.py``'s cases held
against the port, the straggler flags against the JAX package's, and a
resumed run equal to the uninterrupted one bit for bit on the CPU.
Reading checkpoints across the packages: ``test_torch_checkpoint_jax.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _flatten as flatten
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.interop import restore_train_state, to_jax_train_state
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import elastic, trainer

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
                       rng.normal(size=(4, 8)).astype(np.float32)),
                   "b": torch.from_numpy(
                       rng.normal(size=(8,)).astype(np.float32))},
        "opt": {"m": {"w": torch.zeros((4, 8)), "b": torch.zeros((8,))},
                "count": torch.tensor(3, dtype=torch.int32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert list(fa) == list(fb)
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, path
        assert torch.equal(fa[path], fb[path]), path


# --------------------------------------------------------------------------
# the checkpointer: tests/test_checkpoint.py's cases, held against the port
# --------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(s, step=7, metadata={"data": {"step": 7, "seed": 0}})
    restored, meta = ck.restore(s)
    assert meta["data"]["step"] == 7
    _assert_trees_equal(s, restored)


def test_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    s = _state()
    for step in (1, 2, 3, 4):
        ck.save(s, step=step)
    assert ck.latest_step() == 4
    assert ck.available_steps() == [3, 4]  # GC kept the last 2


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    s = _state()
    before = s["params"]["w"].clone()
    ck.save_async(s, step=1)
    s["params"]["w"].add_(1.0)          # after the call: not in the file
    ck.wait()
    assert ck.latest_step() == 1
    restored, _ = ck.restore(s)
    assert torch.equal(restored["params"]["w"], before)


def test_tmp_dir_never_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), step=5)
    assert all(not n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=5)
    s1, s2 = _state(1), _state(2)
    ck.save(s1, step=1)
    ck.save(s2, step=2)
    r1, _ = ck.restore(s1, step=1)
    assert torch.equal(r1["params"]["w"], s1["params"]["w"])


def test_corrupt_tmp_is_ignored(tmp_path):
    """A crashed (uncommitted) write must not break restore."""
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), step=1)
    os.makedirs(tmp_path / "step_0000000002.tmp")  # simulated crash
    assert ck.latest_step() == 1
    restored, _ = ck.restore(_state())
    assert int(restored["step"]) == 7


def test_restore_follows_the_template_device_and_dtype(tmp_path):
    """Each leaf comes back on its template tensor's device and dtype; a
    template leaf that is not a tensor gets the stored array; a failed
    writer thread raises on the next wait."""
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(s, step=1)
    tmpl = _state(5)
    tmpl["opt"]["m"]["w"] = torch.zeros((4, 8), dtype=torch.float64)
    tmpl["step"] = None
    r, _ = ck.restore(tmpl)
    assert r["opt"]["m"]["w"].dtype == torch.float64
    assert isinstance(r["step"], np.ndarray) and r["step"].dtype == np.int32
    assert torch.equal(r["params"]["b"], s["params"]["b"])
    ck.save_async({"x": torch.ones(2)}, step=2,
                  metadata={"bad": object()})   # json cannot write it
    with pytest.raises(RuntimeError, match="asynchronous"):
        ck.wait()


# --------------------------------------------------------------------------
# resume equals the straight run, bit for bit
# --------------------------------------------------------------------------

def _model(policy, seed=0):
    cfg = jconfig("qwen2-0.5b").reduced()
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    return build_model(ModelConfig(**fields), get_policy(policy),
                       LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _dcfg():
    return SyntheticLMConfig(vocab_size=256, seq_len=32, batch_size=2)


def _assert_states_equal(a, b):
    assert int(a["step"]) == int(b["step"])
    for key in ("params", "err"):
        if key in a:
            for n in a[key]:
                assert torch.equal(a[key][n], b[key][n]), (key, n)
    for key, val in a["opt"].items():
        if isinstance(val, dict):
            for n in val:
                assert torch.equal(val[n], b["opt"][key][n]), (key, n)
        else:
            assert torch.equal(val, b["opt"][key])


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_train_resume_equivalence(tmp_path, policy):
    """6 steps straight == 3 steps, checkpoint (data state included),
    restore into a fresh model, 3 more."""
    tc = TrainConfig(policy=get_policy(policy), lr=1e-3)
    ma = _model(policy)
    state_a = trainer.init_train_state(ma, tc)
    step_a, data = trainer.make_train_step(ma, tc), SyntheticLM(_dcfg())
    for _ in range(6):
        state_a, _ = step_a(state_a, next(data))

    mb = _model(policy)
    state_b = trainer.init_train_state(mb, tc)
    step_b, data = trainer.make_train_step(mb, tc), SyntheticLM(_dcfg())
    for _ in range(3):
        state_b, _ = step_b(state_b, next(data))
    ck = Checkpointer(str(tmp_path))
    ck.save(to_jax_train_state(mb, state_b), step=3,
            metadata={"data": data.state()})

    mc = _model(policy, seed=1)                    # other weights: replaced
    state_c = trainer.init_train_state(mc, tc)
    state_c, meta = restore_train_state(ck, mc, state_c)
    data_c = SyntheticLM(_dcfg())
    data_c.restore(meta["data"])
    step_c = trainer.make_train_step(mc, tc)
    for _ in range(3):
        state_c, _ = step_c(state_c, next(data_c))
    _assert_states_equal(state_a, state_c)
    assert state_c["params"]["embed.emb"] is mc.embed.emb


class _PreemptAfter:
    """A guard the loop finds preempted after ``n`` steps."""

    def __init__(self, n):
        self.n = n

    @property
    def preempted(self):
        self.n -= 1
        return self.n < 0


def test_preempted_loop_resumes_like_the_uninterrupted_run(tmp_path):
    tc = TrainConfig(policy=get_policy("fp32"), lr=1e-3,
                     grad_compression="bfp")
    ma = _model("fp32")
    state_a = trainer.init_train_state(ma, tc)
    state_a, _ = elastic.fault_tolerant_train_loop(
        ma, tc, state_a, SyntheticLM(_dcfg()), 4,
        Checkpointer(str(tmp_path / "a")), ckpt_every=2, log_fn=lambda s: 0)

    mb = _model("fp32")
    state_b = trainer.init_train_state(mb, tc)
    ck = Checkpointer(str(tmp_path / "b"))
    logs = []
    state_b, _ = elastic.fault_tolerant_train_loop(
        mb, tc, state_b, SyntheticLM(_dcfg()), 4, ck, ckpt_every=0,
        log_fn=logs.append, guard=_PreemptAfter(2))
    assert int(state_b["step"]) == 3 and ck.available_steps() == [3]
    assert logs and "preempted at step 3" in logs[0]

    mc = _model("fp32", seed=1)
    state_c = trainer.init_train_state(mc, tc)
    state_c, meta = restore_train_state(ck, mc, state_c)
    assert meta["data"]["step"] == 3
    data = SyntheticLM(_dcfg())
    data.restore(meta["data"])
    state_c, _ = elastic.fault_tolerant_train_loop(
        mc, tc, state_c, data, 1, ck, ckpt_every=0)
    _assert_states_equal(state_a, state_c)


def test_straggler_flags_match_jax():
    times = [1.0, 1.1, 0.9, 3.0, 3.2, 2.9, 3.5, 1.0, 5.0, 5.0, 5.0, 5.0,
             0.5, 9.0, 1.0]
    got_events, want_events = [], []
    got = elastic.StragglerMitigator(
        patience=2, on_straggle=lambda s, dt: got_events.append((s, dt)))
    want = jelastic.StragglerMitigator(
        patience=2, on_straggle=lambda s, dt: want_events.append((s, dt)))
    flags = [(got.record(i, t), want.record(i, t))
             for i, t in enumerate(times)]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert any(a for a, _ in flags)
    assert got_events == want_events and got.events == want.events > 0
    assert got.ema == want.ema


def test_launch_train_resumes_bit_for_bit(tmp_path):
    """``launch.train``: 4 steps straight against 2 steps and a resume for
    2 more, both with checkpoints every 2 steps: the step-4 checkpoints
    are equal file by file, the data state included."""
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--reduced", "--seq", "16", "--ckpt-every", "2"]

    def run(*args):
        res = subprocess.run(base + list(args), env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        return res.stdout

    run("--steps", "4", "--ckpt-dir", str(tmp_path / "a"))
    run("--steps", "2", "--ckpt-dir", str(tmp_path / "b"))
    assert "resumed from step 2" in run(
        "--steps", "2", "--ckpt-dir", str(tmp_path / "b"), "--resume")
    a, b = tmp_path / "a" / "step_0000000004", \
        tmp_path / "b" / "step_0000000004"
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    assert ma["metadata"] == mb["metadata"] and ma["leaves"] == mb["leaves"]
    assert ma["metadata"]["data"]["step"] == 4
    for path, fname in ma["leaves"].items():
        np.testing.assert_array_equal(np.load(a / fname), np.load(b / fname),
                                      err_msg=path)
