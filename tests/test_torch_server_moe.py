"""PyTorch port, slice 6a: the MoE family (and the two newly registered
dense configs) served by the port's engines against the JAX engine.

Both reduced MoE configs (qwen3-moe-30b-a3b: 8 experts top-2 with qk-norm;
mixtral-8x7b: 8 experts top-2 with a sliding window) carry the JAX init's
weights into the port, and serve the workload of
``tests/test_spec_prefix.py:59`` (four prompts sharing 8 of 12 tokens, cap
24, two slots) under ``mirage``, as ``tests/test_serving.py:60``,
``tests/test_serving_paged.py:78`` and ``tests/test_spec_prefix.py:19``
serve these families: the port's dense engine (cold and warmed), the paged
engine (with and without chunked prefill), the per-slot oracle and a
``spec_k=2`` engine must each emit the JAX dense engine's greedy streams
token for token. The JAX engine runs once per config (module-scoped).
qwen2-1.5b and qwen3-14b (qk-norm) serve the same workload through the
dense engine. At the published capacity factor 1.25, where prefill
batches drop pairs, mixtral's streams stay equal too. Then the launcher
and the example with ``--arch`` and ``--layers``.
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
from repro_torch.examples import serve_lm
from repro_torch.interop import load_jax_params
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, PerSlotLMServer, Request

ENGINE = dict(cap=24, batch_slots=2)
#: the port's engines, each held to the JAX dense engine's streams
ENGINES = {
    "dense": {},
    "dense_warmed": {},
    "paged": dict(cache_layout="paged", block_size=4),
    "paged_chunk": dict(cache_layout="paged", block_size=4, prefill_chunk=4),
    "spec": dict(cache_layout="paged", block_size=4, spec_k=2),
    "oracle": None,
}


def _shared(cls, n=4, prefix_len=8, total_len=12, max_tokens=4, seed=3,
            vocab=256):
    """``tests/test_spec_prefix.py``'s ``_shared_requests``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, total_len - prefix_len).astype(np.int32)
        out.append(cls(rid=i, prompt=np.concatenate([prefix, tail]),
                       max_tokens=max_tokens))
    return out


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    out = {r.rid: r.tokens_out for r in server.run_until_drained()}
    if getattr(server, "alloc", None) is not None:
        server.alloc.check_invariants()
        assert server.alloc.used_count == 0
    return out


def _served(arch):
    """The JAX engine's streams and the port model on the same weights."""
    cfg = jconfig(arch).reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    want = _drain(JServer(jm, params, **ENGINE), _shared(JRequest))
    tm = build_model(get_config(arch).reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return want, tm


@pytest.fixture(scope="module", params=["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def moe_served(request):
    return (request.param, *_served(request.param))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_moe_engines_equal_jax_engine(moe_served, engine):
    arch, want, tm = moe_served
    assert len(want) == 4 and all(len(t) == 4 for t in want.values())
    if engine == "oracle":
        server = PerSlotLMServer(tm, **ENGINE)
    else:
        server = LMServer(tm, **ENGINE, **ENGINES[engine])
        if engine == "dense_warmed":
            server.warmup()
    assert _drain(server, _shared(Request)) == want, (arch, engine)


def test_dropping_engine_equals_jax_engine():
    """At the published capacity factor 1.25 prefill batches drop (token,
    slot) pairs, and which ones depends on every token of the batch, the
    pads included: the port pads its prefill buckets and batches as the JAX
    engine does, so the streams stay equal."""
    import dataclasses
    from repro_torch.models import moe

    arch = "mixtral-8x7b"
    cfg = dataclasses.replace(jconfig(arch).reduced(), capacity_factor=1.25)
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    want = _drain(JServer(jm, params, **ENGINE), _shared(JRequest))
    tm = build_model(dataclasses.replace(get_config(arch).reduced(),
                                         capacity_factor=1.25),
                     get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    dropped, inner = [], moe.route

    def tap(router, xf, k, C):
        r = inner(router, xf, k, C)
        dropped.append(int((~r.keep).sum()))
        return r

    moe.route = tap
    try:
        got = _drain(LMServer(tm, **ENGINE), _shared(Request))
    finally:
        moe.route = inner
    assert sum(dropped) > 0
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b"])
def test_dense_configs_equal_jax_engine(arch):
    want, tm = _served(arch)
    assert tm.kind == "attn_mlp" and len(want) == 4
    assert _drain(LMServer(tm, **ENGINE), _shared(Request)) == want


def test_launcher_serves_moe_with_layers(capsys):
    """``launch.serve --arch ... --layers N`` builds the config's first N
    layers at its widths and serves through the MoE engine."""
    args = serve.parse_args(["--arch", "mixtral-8x7b", "--reduced",
                             "--layers", "2", "--device", "cpu",
                             "--requests", "2", "--prompt-len", "6",
                             "--max-tokens", "3"])
    model = serve.build(args)
    assert model.cfg.n_layers == 2 and model.kind == "attn_moe"
    assert len(model.layers) == 2 and model.layers[1].moe.gate.shape == (
        8, 64, 32)
    server, finished, _ = serve.serve(model, args)
    assert [len(r.tokens_out) for r in finished] == [3, 3]
    with pytest.raises(SystemExit):
        serve.parse_args(["--layers", "0"])
    assert serve_lm.main(["--arch", "qwen3-moe-30b-a3b", "--layers", "1",
                          "--device", "cpu", "--requests", "2",
                          "--max-tokens", "3"]) == 0
    assert "qwen3-moe-30b-a3b: 2 requests, 6 tokens" in capsys.readouterr().out
