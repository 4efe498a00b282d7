"""PyTorch port: the GEMM error rows of the accuracy-vs-SNR campaign
(``analog/sweep.py``) against the JAX package's: equal, number for number,
when the port replays the JAX package's channel draws (the same key for
every row, as JAX uses). The training rows: ``test_torch_sweep_train.py``."""

import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.analog import sweep as jsweep
from repro_torch.analog import rrns, sweep
from repro_torch.core.precision import get_policy
from test_torch_rns import channel_replay


def _replay(seed):
    def draws(snr_db, mode):
        n = len(rrns.rrns_moduli(get_policy(mode))) if "rrns" in mode else 3
        return channel_replay(jax.random.PRNGKey(seed), n)
    return draws


@pytest.mark.parametrize("overrides", [{}, {"adc_bits": 6}],
                         ids=["plain", "adc6"])
def test_gemm_error_rows_equal_jax_under_replayed_draws(overrides):
    kw = dict(snr_dbs=(36.0, 45.0), shape=(16, 128, 16), seed=4,
              policy_overrides=overrides)
    want = jsweep.gemm_error_sweep(**kw)
    got = sweep.gemm_error_sweep(draws=_replay(4), device="cpu", **kw)
    assert got == want
    # the correction shows: fewer corrupted outputs under RRNS at 45 dB
    by = {(r["mode"], r["snr_db"]): r for r in got}
    assert by[("mirage_rrns", 45.0)]["corrupt_frac"] < \
        by[("mirage_rns_noisy", 45.0)]["corrupt_frac"]


def test_gemm_error_rows_seeded_draws():
    """Without replayed draws each row draws from a generator seeded from
    ``seed``: repeatable, and the rows have JAX's fields."""
    kw = dict(snr_dbs=(40.0,), shape=(8, 64, 8), seed=2, device="cpu")
    a, b = sweep.gemm_error_sweep(**kw), sweep.gemm_error_sweep(**kw)
    assert a == b and len(a) == 2
    assert set(a[0]) == {"section", "mode", "snr_db", "rel_fro_err",
                         "corrupt_frac", "shape"}
