"""PyTorch port, slice 5: the paged engine under ``mirage_rrns`` at 60 dB
against the JAX dense engine.

At 60 dB detector SNR every RRNS decode corrects exactly, so the greedy
streams do not depend on which noise was drawn: the port's prefix-cache and
speculative engines, which draw their noise from other streams than the
dense engine (prefix admissions from the chunk stream, verify ticks once
per k+1 tokens) and other numbers than JAX's, must emit the JAX dense
engine's streams token for token (``tests/test_spec_prefix.py``'s
``test_rrns_high_snr_exact_parity_across_noise_streams``, with two of its
three requests, so that the JAX engine compiles one prefill batch).
"""

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, Request


def _shared(cls, n, prefix_len, total_len, max_tokens=4, seed=3, vocab=256):
    """``tests/test_spec_prefix.py``'s ``_shared_requests``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, total_len - prefix_len).astype(np.int32)
        out.append(cls(rid=i, prompt=np.concatenate([prefix, tail]),
                       max_tokens=max_tokens))
    return out


@pytest.fixture(scope="module")
def engines():
    jm = jbuild(jconfig("qwen2-0.5b").reduced(),
                jpolicy("mirage_rrns", snr_db=60.0, noise_seed=7),
                JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    jserver = JServer(jm, params, cap=24, batch_slots=2)
    for r in _shared(JRequest, 2, 8, 12, seed=5):
        jserver.submit(r)
    want = {r.rid: r.tokens_out for r in jserver.run_until_drained()}
    tm = build_model(get_config("qwen2-0.5b").reduced(),
                     get_policy("mirage_rrns", snr_db=60.0, noise_seed=7),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return want, tm


@pytest.mark.parametrize("opts", [dict(), dict(prefix_cache=True),
                                  dict(spec_k=3)])
def test_rrns_60db_paged_engines_equal_jax_dense_engine(engines, opts):
    want, tm = engines
    s = LMServer(tm, cap=24, batch_slots=2, cache_layout="paged",
                 block_size=4, **opts)
    assert s.stationary_weights
    for r in _shared(Request, 2, 8, 12, seed=5):
        s.submit(r)
    got = {r.rid: r.tokens_out for r in s.run_until_drained()}
    assert got == want and len(got) == 2
    s.alloc.check_invariants()
    assert s.alloc.used_count == 0
    assert s.health_snapshot()["rrns_uncorrected"] == 0
    if opts.get("prefix_cache"):
        assert s.metrics["prefix_hits"] >= 1
