"""PyTorch port: the training rows of the accuracy-vs-SNR campaign
(``analog/sweep.py``). The anchors (``fp32``, ``mirage_rns``) equal JAX's
step-1 losses from the same weights; the noisy rows draw their static
error patterns from each package's own generator, so they are held to the
anchor where the channel moves no residue (90 dB) and to "worse than the
anchor" where it does."""

import numpy as np
import jax
import torch

torch.set_num_threads(2)

from repro.analog import sweep as jsweep
from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro_torch.analog import sweep
from repro_torch.interop import load_jax_params


def test_train_loss_rows():
    cfg = jconfig("qwen2-0.5b").reduced()
    jparams = jax.tree_util.tree_map(np.asarray, jbuild(
        cfg, jpolicy("fp32"), JOptions(q_chunk=16, kv_chunk=16)).init(
            jax.random.PRNGKey(0)))
    rows = sweep.train_loss_sweep(snr_dbs=(90.0, 30.0), steps=1,
                                  device="cpu",
                                  init=lambda m: load_jax_params(m, jparams))
    by = {(r["mode"], r["snr_db"]): r["loss"] for r in rows}
    for name in ("fp32", "mirage_rns"):
        want = jsweep._train_small_lm(jpolicy(name), 1, 0)
        np.testing.assert_allclose(by[(name, None)], want, rtol=1e-6)
    for mode in sweep.NOISY_MODES:
        assert by[(mode, 90.0)] == by[("mirage_rns", None)]
        assert by[(mode, 30.0)] > by[("mirage_rns", None)]
    assert [r["section"] for r in rows] == ["noise_train"] * 6
