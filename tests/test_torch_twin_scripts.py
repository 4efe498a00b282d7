"""PyTorch port: the twins of ``examples/train_lm.py`` and
``examples/serve_lm.py`` run on the CPU.

``train_lm`` checkpoints on preemption and resumes with ``--resume`` on
the batch the stopped run would have taken next: a run stopped after one
step and resumed for one more writes the step-2 checkpoint of the straight
run, file for file; over its first steps the loss falls. ``serve_lm``
serves the dense layout and the paged engine with each of its options."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.examples import serve_lm, train_lm


class _PreemptAfter:
    """Stands in for the SIGTERM guard: preempted after ``n`` steps."""
    n = 0

    def __init__(self):
        self.left = _PreemptAfter.n

    @property
    def preempted(self):
        self.left -= 1
        return self.left < 0

    def uninstall(self):
        pass


def _run(monkeypatch, capsys, preempt_after, *args):
    _PreemptAfter.n = preempt_after
    monkeypatch.setattr(train_lm, "PreemptionGuard", _PreemptAfter)
    capsys.readouterr()
    assert train_lm.main(["--small", "--device", "cpu", "--seq", "16",
                          "--batch", "4"] + list(args)) == 0
    return capsys.readouterr().out


def test_train_lm_resumes_on_the_next_batch(tmp_path, monkeypatch, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    out = _run(monkeypatch, capsys, 1, "--steps", "5", "--ckpt-dir", a)
    assert "preempted at step 2" in out and "done at step 2" in out
    _run(monkeypatch, capsys, 0, "--steps", "5", "--ckpt-dir", b)
    out = _run(monkeypatch, capsys, 0, "--steps", "5", "--ckpt-dir", b,
               "--resume")
    assert "resumed at step 1" in out and "done at step 2" in out
    sa, sb = tmp_path / "a" / "step_0000000002", \
        tmp_path / "b" / "step_0000000002"
    ma = json.loads((sa / "manifest.json").read_text())
    mb = json.loads((sb / "manifest.json").read_text())
    assert ma["metadata"] == mb["metadata"] == {
        "data": {"step": 2, "seed": 0, "shard_id": 0, "num_shards": 1}}
    assert "err/embed/emb" in ma["leaves"]       # BFP error feedback
    for path, fname in ma["leaves"].items():
        np.testing.assert_array_equal(np.load(sa / fname),
                                      np.load(sb / fname), err_msg=path)


def test_train_lm_learns(tmp_path, monkeypatch, capsys):
    """Three steps: the loss printed at the end is below the first step's
    (the JAX script's lr 3e-4, microbatches 2, BFP gradient compression)."""
    from repro_torch.runtime import trainer
    losses = []
    real = trainer.make_train_step

    def spy(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            return state, met
        return wrapped

    monkeypatch.setattr(trainer, "make_train_step", spy)
    out = _run(monkeypatch, capsys, 99, "--steps", "3", "--ckpt-dir",
               str(tmp_path))
    assert out.startswith("model ~5M params, policy=mirage")
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_serve_lm_dense(capsys):
    assert serve_lm.main(["--device", "cpu", "--requests", "3",
                          "--max-tokens", "4", "--stream"]) == 0
    out = capsys.readouterr().out
    assert "qwen2-0.5b: 3 requests, 12 tokens" in out
    assert out.count("[req ") == 12


@pytest.mark.parametrize("flags", [["--cache-layout", "paged"],
                                   ["--cache-layout", "paged",
                                    "--prefill-chunk", "4"],
                                   ["--cache-layout", "paged",
                                    "--prefix-cache"],
                                   ["--cache-layout", "paged", "--spec-k",
                                    "2"]])
def test_serve_lm_paged_options(capsys, flags):
    """The paged engine serves the demo's 3 x 4 tokens with each option,
    streaming each token once."""
    assert serve_lm.main(["--device", "cpu", "--requests", "3",
                          "--max-tokens", "4", "--stream"] + flags) == 0
    out = capsys.readouterr().out
    assert "qwen2-0.5b: 3 requests, 12 tokens" in out
    assert out.count("[req ") == 12
    if "--prefix-cache" in flags:
        assert "prefix hits: 2 (4 blocks shared)" in out
    if "--spec-k" in flags:
        assert "spec accepted/tick:" in out


def test_serve_lm_prefill_chunk_needs_paged():
    with pytest.raises(ValueError, match="prefill_chunk requires"):
        serve_lm.main(["--device", "cpu", "--prefill-chunk", "4"])


def test_serve_lm_spec_k_needs_paged():
    with pytest.raises(SystemExit):
        serve_lm.main(["--device", "cpu", "--spec-k", "2"])
