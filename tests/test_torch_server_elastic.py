"""PyTorch port, slice 5: elastic slot and block-pool resize against the
JAX engine.

Reduced qwen2 under ``mirage`` with the JAX init's weights in both
packages. The engines of ``tests/test_serving.py:253`` and
``tests/test_serving_paged.py:302-333`` grow from 2 to 3 slots after two
ticks (the paged one also shrinks its pool to just above the live blocks
and grows it back); each port engine's streams must equal the JAX engine
making the same moves, token for token, and the port's fixed-size engine.
``resize_serving_state`` and ``resize_block_pool`` are held to JAX's leaf
for leaf on one state. The JAX engines run once per module
(``jax_streams``); the ``switch_backend`` twins are in
``tests/test_torch_server_switch.py``, so that each file stays short.
"""

import copy

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import elastic as jelastic
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import elastic
from repro_torch.runtime.server import LMServer, Request

PAGED = dict(cache_layout="paged", block_size=8)


def _requests(cls, n=5, lens=(8,), max_tokens=5, seed=9, vocab=256):
    """``tests/test_serving.py``'s ``_mk_requests(cfg, 5, lens=[8],
    max_tokens=5, seed=9)``."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)]
                                           ).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _submit(server, reqs, ticks=2):
    for r in reqs:
        server.submit(r)
    for _ in range(ticks):
        server.tick()
    return server


def _streams(server):
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.run_until_drained()}


def _grow(server, paged):
    """The moves of the JAX tests: 2 -> 3 slots after two ticks, then (paged)
    the pool down to just above its live blocks and back to 9."""
    server.resize_slots(3)
    if paged:
        server.resize_block_pool(server.alloc.used_count + 2)
        server.resize_block_pool(9)
        server.alloc.check_invariants()
    return server


@pytest.fixture(scope="module")
def jax_model():
    jm = jbuild(jconfig("qwen2-0.5b").reduced(), jpolicy("mirage"),
                JOptions(q_chunk=16, kv_chunk=16))
    return jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(jax_model):
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jax_model[1]))
    return tm


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    """The JAX engines' streams, and each engine's state and allocator as
    they were before the moves."""
    jm, params = jax_model
    out = {}
    for name, kw in (("dense", {}), ("paged", PAGED)):
        s = _submit(JServer(jm, params, cap=24, batch_slots=2, **kw),
                    _requests(JRequest))
        out[f"state_{name}"] = jax.tree_util.tree_map(np.asarray, s.state)
        out[f"alloc_{name}"] = copy.deepcopy(s.alloc)
        out[name] = _streams(_grow(s, bool(kw)))
    return out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_resize_slots_preserves_tokens(model, jax_streams, layout):
    """``tests/test_serving.py::test_resize_slots_preserves_tokens`` and
    ``tests/test_serving_paged.py::
    test_paged_resize_slots_and_pool_preserve_tokens``: the in-flight slots
    carried across the moves keep emitting their continuations."""
    kw = PAGED if layout == "paged" else {}
    grown = _grow(_submit(LMServer(model, cap=24, batch_slots=2, **kw),
                          _requests(Request)), layout == "paged")
    assert grown.n_slots == 3 and len(grown.slot_req) == 3
    got = _streams(grown)
    fixed = _submit(LMServer(model, cap=24, batch_slots=3, **kw),
                    _requests(Request), ticks=0)
    assert len(got) == 5
    assert got == _streams(fixed) == jax_streams[layout]
    if grown.alloc is not None:
        grown.alloc.check_invariants()
        assert grown.alloc.used_count == 0 and grown.alloc.n_blocks == 9


def test_pool_shrink_below_live_blocks_raises(model):
    """``tests/test_serving_paged.py::
    test_pool_shrink_below_live_blocks_raises``, and the other refusals."""
    server = LMServer(model, cap=24, batch_slots=2, **PAGED)
    _submit(server, _requests(Request, n=2, lens=(10,), max_tokens=6,
                              seed=0), ticks=1)
    with pytest.raises(ValueError, match="do not fit"):
        server.resize_block_pool(1)
    with pytest.raises(ValueError, match="cannot shrink"):
        server.resize_slots(1)
    server.run_until_drained()
    with pytest.raises(RuntimeError, match="paged"):
        LMServer(model, cap=24, batch_slots=2).resize_block_pool(8)
    chunked = LMServer(model, cap=24, batch_slots=2, prefill_chunk=4,
                       **PAGED)
    _submit(chunked, _requests(Request, n=1), ticks=1)
    with pytest.raises(RuntimeError, match="in flight"):
        chunked.resize_slots(3)
    with pytest.raises(ValueError, match="do not fit"):
        elastic.resize_serving_state(model, chunked.state, 24, 1,
                                     keep=[0, 1])


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_leaves_equal(jtree, ttree, path=""):
    assert set(jtree) == set(ttree), path
    for k, v in jtree.items():
        if isinstance(v, dict):
            _assert_leaves_equal(v, ttree[k], f"{path}/{k}")
        else:
            want = np.asarray(v)
            got = ttree[k].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, \
                f"{path}/{k}"
            np.testing.assert_array_equal(got, want, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_resize_functions_match_jax_leaf_for_leaf(jax_model, model,
                                                  jax_streams, layout):
    """The JAX engine's state after two ticks, resized by both packages'
    ``resize_serving_state`` (the kept slots swapped, to 4 slots) and,
    paged, ``resize_block_pool`` (down to one block above the live ones,
    then up to 40) on allocators driven alike: every leaf equal, and the
    same block renumbering."""
    kw = PAGED if layout == "paged" else {}
    jstate = jax_streams[f"state_{layout}"]
    tstate = _to_torch(jstate)
    keep = [1, 0]
    _assert_leaves_equal(
        jax.tree_util.tree_map(np.asarray, jelastic.resize_serving_state(
            jax_model[0], jstate, 24, 4, keep)),
        elastic.resize_serving_state(model, tstate, 24, 4, keep))
    if layout == "dense":
        return
    ts = _submit(LMServer(model, cap=24, batch_slots=2, **kw),
                 _requests(Request))
    jalloc = copy.deepcopy(jax_streams["alloc_paged"])
    np.testing.assert_array_equal(ts.alloc.tables, jalloc.tables)
    for n in (jalloc.used_count + 1, 40):
        jnew, jold_ids, jnew_ids = jelastic.resize_block_pool(
            jstate, jalloc, n)
        tnew, told_ids, tnew_ids = elastic.resize_block_pool(
            tstate, ts.alloc, n)
        np.testing.assert_array_equal(np.asarray(told_ids), jold_ids)
        np.testing.assert_array_equal(np.asarray(tnew_ids), jnew_ids)
        _assert_leaves_equal(jax.tree_util.tree_map(np.asarray, jnew), tnew)
        assert not ts.alloc.dirty
        jstate, tstate = jax.tree_util.tree_map(np.asarray, jnew), tnew
