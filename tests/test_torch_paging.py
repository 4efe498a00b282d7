"""PyTorch port, paged KV: the port's allocator and prefix index against the
JAX package's, op for op, and the paged cache and attention steps against
the JAX functions on the same inputs.

``repro_torch.runtime.paging`` is the port's own copy of
``repro.runtime.paging``: the same seeded sequences of ensure, share,
copy-on-write fork, release, trim, slot remap, pool resize and quarantine
go to both allocators (and insert, match, evict and remap to both prefix
indexes), and every table, refcount, free heap, ``lo`` and counter must
match after every op, as must every result and every refusal. The paged
decode, verify and chunk attention steps are held to the JAX ones within
1e-5 (fp32, reduced qwen2, one layer's weights carried over), and the
paged ``init_cache`` to JAX's ``cache_spec``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tests._hypothesis_compat import given, settings, st

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import attention as jattention
from repro.models import build_model as jbuild
from repro.models import lm as jlm
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import paging as jpaging
from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import attention, build_model
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime import paging

ALLOC_FIELDS = ("n_blocks", "block_size", "n_slots", "max_blocks_per_slot",
                "n_shards", "placement", "sentinel", "_per_shard",
                "peak_in_use", "local_allocs", "spilled_allocs", "_rr",
                "dirty", "free_count", "used_count", "occupancy",
                "fragmentation")


def _same_alloc(a, b):
    for name in ALLOC_FIELDS:
        assert getattr(a, name) == getattr(b, name), name
    for name in ("tables", "refcount", "n_owned", "lo"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a._free == b._free
    assert a.quarantined == b.quarantined
    assert a.free_by_shard() == b.free_by_shard()
    assert a.remote_fraction() == b.remote_fraction()
    a.check_invariants()
    b.check_invariants()


def _same_index(a, b):
    assert a.by_key == b.by_key and a.by_block == b.by_block
    assert len(a) == len(b)


def _both(fa, fb, same_message=True):
    """Call both; equal results, or the same refusal."""
    try:
        ra = fa()
    except Exception as exc:          # noqa: BLE001 — compared below
        with pytest.raises(type(exc)) as info:
            fb()
        if same_message:
            assert str(info.value) == str(exc)
        return None
    rb = fb()
    if isinstance(ra, tuple) and len(ra) == 2 and \
            isinstance(ra[0], np.ndarray):
        np.testing.assert_array_equal(ra[0], rb[0])
        np.testing.assert_array_equal(ra[1], rb[1])
    else:
        assert ra == rb
    return ra


def _random_op(rng, ref):
    """One op on ``ref``'s current state: (name, args)."""
    S, mb, bs = ref.n_slots, ref.max_blocks_per_slot, ref.block_size
    kind = rng.choice(["ensure", "ensure", "ensure", "share", "fork",
                       "release", "trim", "quarantine", "unquarantine",
                       "resize", "remap"])
    slot = int(rng.integers(0, S))
    if kind == "ensure":
        return kind, (slot, int(rng.integers(0, mb * bs + 3)))
    if kind == "share":
        row = set(int(b) for b in ref.tables[slot])
        live = [b for b in np.nonzero(ref.refcount > 0)[0].tolist()
                if b not in row]
        n = int(rng.integers(0, min(len(live), 3) + 1))
        picks = rng.choice(live, size=n, replace=False).tolist() if n else []
        if rng.random() < 0.1 and ref.refcount[-1] == 0:
            picks = [ref.n_blocks - 1]          # a dead block: a refusal
        return kind, (slot, [int(b) for b in picks])
    if kind == "fork":
        return kind, (slot, int(rng.integers(0, mb)))
    if kind == "release":
        return kind, (slot,)
    if kind == "trim":
        return kind, (slot, int(rng.integers(-2, mb * bs + 2)))
    if kind == "quarantine":
        return kind, (int(rng.integers(0, 4)),)
    if kind == "unquarantine":
        q = sorted(ref.quarantined)
        if q and rng.random() < 0.5:
            return kind, (q[:int(rng.integers(1, len(q) + 1))],)
        return kind, (None,)
    if kind == "resize":
        used = int(ref.used_count)
        n = int(rng.integers(max(used, 1), ref.n_blocks + 6))
        n += (-n) % ref.n_shards
        return kind, (n,)
    keep = sorted(rng.choice(S, size=int(rng.integers(0, S + 1)),
                             replace=False).tolist())
    return kind, ([int(i) for i in keep],
                  int(rng.integers(max(len(keep), 1), S + 2)))


def _apply(alloc, index, kind, args, rng_prompt):
    """Run one op on one (allocator, prefix index) pair the way the engine
    does (freed ids leave the index, a resize remaps it)."""
    if kind == "ensure":
        alloc.ensure(*args)
        slot = args[0]
        n = int(alloc.n_owned[slot])
        if n and int(alloc.lo[slot]) == 0:
            index.insert_chain(rng_prompt[:n * alloc.block_size],
                               alloc.tables[slot, :n].tolist())
        return None
    if kind == "share":
        return alloc.share(*args)
    if kind == "fork":
        out = alloc.fork_cow(*args)
        if out is not None:
            index.evict_blocks([out[0]])
        return out
    if kind in ("release", "trim"):
        freed = alloc.release(*args) if kind == "release" else \
            alloc.trim_below(*args)
        index.evict_blocks(freed)
        return freed
    if kind == "quarantine":
        return alloc.quarantine(*args)
    if kind == "unquarantine":
        return alloc.unquarantine(*args)
    if kind == "resize":
        old, new = alloc.resize_pool(*args)
        index.remap({int(o): int(n) for o, n in zip(old, new)})
        return old, new
    freed = alloc.remap_slots(*args)
    index.evict_blocks(freed)
    return freed


def _run_differential(ops_seed, n_ops, n_blocks, bs, S, mb, n_shards,
                      placement):
    rng = np.random.default_rng(ops_seed)
    prompt = rng.integers(0, 50, mb * bs * 2).astype(np.int32)
    ja = jpaging.BlockAllocator(n_blocks, bs, S, mb, n_shards=n_shards,
                                placement=placement)
    ta = paging.BlockAllocator(n_blocks, bs, S, mb, n_shards=n_shards,
                               placement=placement)
    ji, ti = jpaging.PrefixIndex(bs), paging.PrefixIndex(bs)
    _same_alloc(ja, ta)
    for _ in range(n_ops):
        kind, args = _random_op(rng, ja)
        _both(lambda: _apply(ja, ji, kind, args, prompt),
              lambda: _apply(ta, ti, kind, args, prompt))
        _same_alloc(ja, ta)
        _same_index(ji, ti)
        probe = prompt[:int(rng.integers(0, len(prompt)))]
        assert ji.match(probe) == ti.match(probe)
        b = int(rng.integers(0, ja.n_blocks))
        assert ji.contains_block(b) == ti.contains_block(b)
        assert paging.blocks_for(len(probe), bs) == \
            jpaging.blocks_for(len(probe), bs)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_shards,placement", [
    (1, "locality"), (2, "locality"), (2, "round_robin")])
def test_allocator_and_index_match_jax_op_for_op(seed, n_shards, placement):
    _run_differential(seed, 250, n_blocks=12, bs=4, S=3, mb=5,
                      n_shards=n_shards, placement=placement)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3), st.integers(1, 5),
       st.integers(2, 4), st.sampled_from([1, 2]))
def test_allocator_differential_property(seed, bs, S, mb, n_shards):
    n_blocks = max(2, S * mb - 1)
    n_blocks += (-n_blocks) % n_shards
    _run_differential(seed, 60, n_blocks, bs, S, mb, n_shards,
                      "locality")


def test_allocator_refusals_match():
    """Bad geometry, an unknown placement and an exhausted pool refuse the
    same way in both packages (the shard-geometry message names no XLA in
    the port)."""
    for args, kw in (((0, 4, 2, 2), {}), ((6, 4, 2, 2), {"n_shards": 4}),
                     ((6, 4, 2, 2), {"placement": "nope"})):
        _both(lambda: jpaging.BlockAllocator(*args, **kw),
              lambda: paging.BlockAllocator(*args, **kw),
              same_message="n_shards" not in kw)
    ja, ta = (mod.BlockAllocator(3, 2, 2, 4) for mod in (jpaging, paging))
    _both(lambda: ja.ensure(0, 6), lambda: ta.ensure(0, 6))
    _both(lambda: ja.ensure(1, 4), lambda: ta.ensure(1, 4))   # exhausted
    _both(lambda: ja.ensure(1, 9), lambda: ta.ensure(1, 9))   # table full
    _same_alloc(ja, ta)


def test_port_paging_imports_no_jax_package():
    src = open(paging.__file__).read()
    assert "import jax" not in src and "from repro." not in src
    assert paging.BlockAllocator is not jpaging.BlockAllocator


# --------------------------------------------------------------------------
# the paged cache and attention steps vs the JAX functions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """fp32 reduced qwen2 in both packages with the JAX init's weights."""
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy("fp32"), JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy("fp32"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return cfg, jm, params, tm


@pytest.mark.parametrize("cap,bs,n_blocks", [(24, 8, None), (20, 4, 7),
                                             (17, 4, None)])
def test_paged_init_cache_matches_jax_cache_spec(models, cap, bs, n_blocks):
    _, jm, _, tm = models
    want = jm.cache_spec(3, cap, per_slot_idx=True, layout="paged",
                         block_size=bs, n_blocks=n_blocks)
    got = tm.cache_spec(3, cap, per_slot_idx=True, layout="paged",
                        block_size=bs, n_blocks=n_blocks)
    assert {k: tuple(s) for k, (s, _) in want.items()} == \
        {k: s for k, (s, _) in got.items()}
    cache = tm.init_cache(3, cap, per_slot_idx=True, layout="paged",
                          block_size=bs, n_blocks=n_blocks)
    jcache = jm.init_cache(3, cap, per_slot_idx=True, layout="paged",
                           block_size=bs, n_blocks=n_blocks)
    for k, leaf in cache.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jcache[k]))
    assert cache["bt"].dtype == torch.int32 and cache["kp"].dtype == \
        torch.float32
    with pytest.raises(ValueError, match="layout"):
        tm.init_cache(3, cap, layout="ring")
    # the dense layout's spec is JAX's too
    dense = tm.cache_spec(3, cap, per_slot_idx=True)
    assert {k: s for k, (s, _) in dense.items()} == {
        k: tuple(s) for k, (s, _) in jm.cache_spec(
            3, cap, per_slot_idx=True).items()}


def _layer_params(params, models_tm, li=1):
    jp = jax.tree_util.tree_map(lambda a: a[li], params["layers"]["attn"])
    return jp, models_tm.layers[li].attn


def _attn_kw(cfg, window):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                window=window)


def _pools(seed, NB, bs, kv, hd):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(NB, bs, kv, hd)).astype(np.float32)
    v = rng.normal(size=(NB, bs, kv, hd)).astype(np.float32)
    return k, v


# slot 0 maps three blocks, slot 1 two (then the sentinel), slot 2 none
TABLE = np.array([[3, 7, 1, 12, 12], [0, 2, 12, 12, 12],
                  [12, 12, 12, 12, 12]], np.int32)


@pytest.mark.parametrize("window", [None, 3])
def test_paged_decode_step_matches_jax(models, window):
    cfg, _, params, tm = models
    jp, tp = _layer_params(params, tm)
    NB, bs, hd = 12, 4, cfg.resolved_head_dim
    k, v = _pools(1, NB, bs, cfg.n_kv_heads, hd)
    x = np.random.default_rng(2).normal(size=(3, 1, cfg.d_model)).astype(
        np.float32)
    idx = np.array([9, 5, 0], np.int32)   # slot 2 writes to the sentinel
    kw = _attn_kw(cfg, window)
    jo, jk, jv = attention_j(jattention.attn_decode_step, jp, x, k, v, idx,
                             TABLE, kw)
    with torch.inference_mode():
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        to, _, _ = attention.attn_decode_step(
            tp, torch.from_numpy(x), tk, tv, torch.from_numpy(idx),
            get_policy("fp32"), block_tables=torch.from_numpy(TABLE), **kw)
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), jk, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tk.numpy()[12 - 1], k[12 - 1])


def attention_j(fn, jp, x, k, v, idx, table, kw):
    pol = jpolicy("fp32")
    o, kk, vv = fn(jp, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(idx), pol, block_tables=jnp.asarray(table),
                   **kw)
    return np.asarray(o), np.asarray(kk), np.asarray(vv)


@pytest.mark.parametrize("window", [None, 4])
def test_verify_step_matches_jax(models, window):
    """T = 4 positions a slot; slot 1's last positions fall on the
    sentinel (dropped), slot 2 maps nothing."""
    cfg, _, params, tm = models
    jp, tp = _layer_params(params, tm)
    NB, bs, hd = 12, 4, cfg.resolved_head_dim
    k, v = _pools(3, NB, bs, cfg.n_kv_heads, hd)
    x = np.random.default_rng(4).normal(size=(3, 4, cfg.d_model)).astype(
        np.float32)
    idx = np.array([6, 6, 1], np.int32)
    kw = _attn_kw(cfg, window)
    jo, jk, jv = attention_j(jattention.attn_verify_step, jp, x, k, v, idx,
                             TABLE, kw)
    with torch.inference_mode():
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        to, _, _ = attention.attn_verify_step(
            tp, torch.from_numpy(x), tk, tv, torch.from_numpy(idx),
            get_policy("fp32"), block_tables=torch.from_numpy(TABLE), **kw)
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), jk, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pos0,C,true_len,window", [
    (0, 8, 8, None), (4, 8, 5, None), (8, 4, 4, 5), (10, 8, 2, None)])
def test_chunk_step_matches_jax(models, pos0, C, true_len, window):
    """Pads (``j >= true_len``) and positions past the mapped blocks are
    dropped; the rest of the row attends through the gathered pages."""
    cfg, _, params, tm = models
    jp, tp = _layer_params(params, tm)
    NB, bs, hd = 12, 4, cfg.resolved_head_dim
    k, v = _pools(5, NB, bs, cfg.n_kv_heads, hd)
    x = np.random.default_rng(6).normal(size=(1, C, cfg.d_model)).astype(
        np.float32)
    row = TABLE[0]
    kw = dict(_attn_kw(cfg, window), q_chunk=16, kv_chunk=16)
    jo, jk, jv = jattention.attn_chunk_step(
        jp, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v), jnp.asarray(row),
        pos0, true_len, jpolicy("fp32"), **kw)
    with torch.inference_mode():
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        to, _, _ = attention.attn_chunk_step(
            tp, torch.from_numpy(x), tk, tv, torch.from_numpy(row), pos0,
            true_len, get_policy("fp32"), **kw)
    real = slice(0, true_len)
    np.testing.assert_allclose(to.numpy()[:, real],
                               np.asarray(jo)[:, real], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layered", [False, True])
def test_write_pages_drops_like_mode_drop(layered):
    """Rows through the sentinel, past the table and pads are dropped, even
    where their clamped cell is a kept row's; a step that keeps no row
    changes nothing."""
    NB, bs = 4, 2
    pages = torch.arange(NB * bs * 2, dtype=torch.float32).reshape(
        NB, bs, 1, 2) + 0.5
    if layered:
        pages = torch.stack([pages, -pages])
    table = torch.tensor([[3, 4], [4, 4], [0, 1]], dtype=torch.int32)
    pos = torch.tensor([[1, 2], [0, 1], [3, 4]])     # 4 lies past mb * bs
    vals = torch.arange(12, dtype=torch.float32).reshape(3, 2, 1, 2) * 10
    if layered:
        vals = torch.stack([vals, vals + 1])
    before = pages.clone()
    plan = attention.page_plan(table, pos, NB, bs)
    attention.write_pages(pages, plan, vals)
    want = before.clone()
    cell = (lambda b, o: (slice(None), b, o)) if layered else \
        (lambda b, o: (b, o))
    want[cell(3, 1)] = vals[(slice(None), 0, 0) if layered else (0, 0)]
    want[cell(1, 1)] = vals[(slice(None), 2, 0) if layered else (2, 0)]
    assert torch.equal(pages, want)
    none = attention.page_plan(table[1:2], pos[1:2], NB, bs)
    attention.write_pages(pages, none, vals[..., 1:2, :, :, :] if layered
                          else vals[1:2])
    assert torch.equal(pages, want)


def test_cache_insert_and_extract_paged_match_jax(models):
    """A right-padded prefill batch scatters through the live tables into
    the pools (sentinel rows and unmapped blocks dropped), as JAX's
    ``cache_insert`` does; ``cache_extract`` passes the pools through."""
    cfg, jm, params, tm = models
    cap, bs, NB = 20, 4, 10
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    lens = np.array([8, 5, 8, 1], np.int32)
    slots = np.array([2, 0, 3, 3], np.int32)     # 3 = the OOB sentinel
    table = np.full((3, 5), NB, np.int32)
    table[2, :2], table[0, :2] = [4, 9], [1, 0]  # slot 0: 8 of 5 positions
    jlive = jm.init_cache(3, cap, per_slot_idx=True, layout="paged",
                          block_size=bs, n_blocks=NB)
    jlive["bt"] = jnp.asarray(table)
    _, jnew = jm.prefill(params, jnp.asarray(toks), cap,
                         lens=jnp.asarray(lens))
    want = jlm.cache_insert(jlive, jnew, jnp.asarray(slots))
    with torch.inference_mode():
        live = tm.init_cache(3, cap, per_slot_idx=True, layout="paged",
                             block_size=bs, n_blocks=NB)
        live["bt"].copy_(torch.from_numpy(table))
        _, new = tm.prefill(torch.from_numpy(toks), cap,
                            lens=torch.from_numpy(lens))
        got = tlm.cache_insert(live, new, torch.from_numpy(slots).long())
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5, rtol=0, err_msg=k)
        ext = tlm.cache_extract(got, [2, 0])
    jext = jlm.cache_extract(want, [2, 0])
    assert ext["kp"] is got["kp"]
    for k in ("idx", "bt"):
        np.testing.assert_array_equal(ext[k].numpy(), np.asarray(jext[k]))


def test_paged_decode_equals_dense_decode(models):
    """The same prompts prefilled into both layouts decode to the same
    logits bit for bit when the paged span equals the ring (cap = 5 x 4):
    the gather orders positions as the ring does and masked cells weigh
    exactly 0."""
    cfg, _, _, tm = models
    cap, bs, S = 20, 4, 3
    alloc = paging.BlockAllocator(S * 5, bs, S, 5)
    with torch.inference_mode():
        dense = tm.init_cache(S, cap, per_slot_idx=True)
        paged = tm.init_cache(S, cap, layout="paged", block_size=bs)
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int64))
        _, new = tm.prefill(toks, cap, lens=torch.tensor([8, 6]))
        for slot, n in ((0, 8), (2, 6)):
            alloc.ensure(slot, n)
        paged["bt"].copy_(torch.from_numpy(alloc.tables))
        slots = torch.tensor([0, 2])
        tlm.cache_insert(dense, new, slots)
        tlm.cache_insert(paged, new, slots)
        last = torch.tensor([[1], [2], [3]])
        for _ in range(5):
            for slot in (0, 2):
                alloc.ensure(slot, int(paged["idx"][slot]) + 1)
            paged["bt"].copy_(torch.from_numpy(alloc.tables))
            ld, dense = tm.decode_step(dense, last)
            lp, paged = tm.decode_step(paged, last)
            assert torch.equal(ld[[0, 2]], lp[[0, 2]])
            last = torch.argmax(ld[:, -1], dim=-1, keepdim=True)


def test_swa_config_replace_keeps_paged_spec(models):
    """A sliding window changes the dense ring's length but not the paged
    pools (linear addressing), in both packages."""
    cfg, _, _, _ = models
    jcfg = dataclasses.replace(cfg, sliding_window=8)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               sliding_window=8)
    jm = jbuild(jcfg, jpolicy("fp32"))
    tm = build_model(tcfg, get_policy("fp32"), device="cpu")
    for layout in ("dense", "paged"):
        want = jm.cache_spec(2, 20, per_slot_idx=True, layout=layout,
                             block_size=4)
        got = tm.cache_spec(2, 20, per_slot_idx=True, layout=layout,
                            block_size=4)
        assert {k: tuple(s) for k, (s, _) in want.items()} == \
            {k: s for k, (s, _) in got.items()}
