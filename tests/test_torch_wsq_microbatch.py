"""PyTorch port: weight-stationary training with bf16 copies and two
microbatches, against the JAX step. The JAX package adds each
microbatch's gradients into f32 zeros; the port casts the bf16 gradients
of the quantized copies before the sum, so its AdamW moments after one
step equal JAX's within 1e-5 of each leaf's largest element (a bf16 sum
missed by up to 3.75e-3)."""

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
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.precision import get_policy
from repro_torch.interop import _by_name, load_jax_train_state
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import trainer


@pytest.mark.parametrize("qdtype", ["bfloat16", "float32"])
def test_two_microbatch_wsq_moments_match_jax(qdtype):
    cfg = jconfig("qwen2-0.5b").reduced()
    kw = dict(weight_stationary_quant=True, quant_param_dtype=qdtype,
              microbatches=2)
    jp = jpolicy("mirage", assume_quantized_weights=True)
    jm = jbuild(cfg, jp, JOptions(q_chunk=32, kv_chunk=32))
    jtc = JTrainConfig(policy=jp, optimizer="adamw", lr=1e-3, **kw)
    jstate = jtrainer.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    tp = get_policy("mirage", assume_quantized_weights=True)
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    tm = build_model(ModelConfig(**fields), tp,
                     LMCallOptions(q_chunk=32, kv_chunk=32), device="cpu")
    tstate = load_jax_train_state(
        tm, jax.tree_util.tree_map(np.asarray, jstate),
        TrainConfig(policy=tp, optimizer="adamw", lr=1e-3, **kw))
    batch = JSyntheticLM(JSyntheticLMConfig(vocab_size=256, seq_len=32,
                                            batch_size=4)).batch_at(0)
    jstate, jmet = jax.jit(jtrainer.make_train_step(jm, jtc))(jstate, batch)
    tstate, tmet = trainer.make_train_step(
        tm, TrainConfig(policy=tp, optimizer="adamw", lr=1e-3, **kw))(
            tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    quantized = set(trainer._quantized_names(tstate["params"]))
    assert len(quantized) == 7 * cfg.n_layers
    for key in ("m", "v"):
        want = _by_name(tm, jax.tree_util.tree_map(np.asarray,
                                                   jstate["opt"][key]))
        for n, arr in want.items():
            got = tstate["opt"][key][n].numpy()
            scale = float(np.abs(arr).max()) + 1e-30
            assert float(np.abs(got - arr).max()) <= 1e-5 * scale, (key, n)
