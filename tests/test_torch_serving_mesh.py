"""The port's meshed serving engine (``LMServer(mesh=...)``) on the CPU over
gloo, held to the single-device port engine, which is held to the JAX
engine.

The JAX package's own meshed tests (``tests/test_serving_mesh.py``) are red
on this JAX version, so the gate runs in two steps: the single-device port
engine's streams equal the JAX ``LMServer``'s (jitted, on the same
weights and requests, in every case but the noisy one), and the meshed
port engine's equal the single-device port engine's. One module fixture
starts the 4 ranks of a 2x2 (data, model) mesh once
(``tests/_torch_serve_ranks.py``) and every check reads what they wrote:
the JAX test's five cases (and qwen2 under fp32 on dense rings), sampled
decode, the sharded allocator, ``round_robin`` blocks under chunked
prefill, the prefix cache and speculative decoding, snapshots crossing
between the mesh and one device, ``launch.serve --distributed`` and the
two options a mesh refuses. The JAX engines run in this process while the
ranks run.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import _torch_serve_ranks as ranks  # noqa: E402
from repro_torch.interop import _jax_layout  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

#: a divergence of the meshed stream is a tie only below this top-2 logit
#: gap at its first diverging token (the MoE routing gate's rule)
TIE_GAP = 1e-5

#: the cases the JAX engine serves too: all but mirage_rrns, whose noise
#: the two packages draw from different generators
JAX_CASES = tuple(c for c in ranks.CASES if c[1] != "mirage_rrns")


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Start the ranks, run the JAX engine meanwhile, wait for the ranks."""
    out = tmp_path_factory.mktemp("serve_ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_serve_ranks.py"),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        jax_streams = {case: _jax_engine_streams(*case)
                       for case in JAX_CASES}
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]

    def load(name):
        return torch.load(os.path.join(out, name), weights_only=False)
    return SimpleNamespace(dir=str(out), load=load, jax=jax_streams,
                           cases=load("cases.pt"))


def _jax_engine_streams(arch, pol, layout):
    """The JAX engine's streams of one case on the port's weights (handed
    over through ``interop``: no JAX init)."""
    import jax.numpy as jnp
    from repro.configs import get_config as jconfig
    from repro.core.precision import get_policy as jpolicy
    from repro.models import build_model as jbuild
    from repro.models.lm import LMCallOptions as JOptions
    from repro.runtime.server import LMServer as JServer
    from repro.runtime.server import Request as JRequest

    model = ranks.build(arch, pol)
    jm = jbuild(jconfig(arch).reduced(), jpolicy(pol),
                JOptions(q_chunk=16, kv_chunk=16))
    params = _jax_layout(model, dict(model.named_parameters()),
                         lambda t: jnp.asarray(t.detach().numpy()),
                         jnp.stack)
    kw = dict(block_size=16, n_blocks=32) if layout == "paged" else {}
    srv = JServer(jm, params, cap=64, batch_slots=4, buckets=(16,),
                  cache_layout=layout, **kw)
    for r in ranks.requests(model.cfg):
        srv.submit(JRequest(rid=r.rid, prompt=r.prompt,
                            max_tokens=r.max_tokens))
    srv.run_until_drained()
    return {r.rid: list(map(int, r.tokens_out))
            for r in srv.scheduler.finished}


def _first_gap(arch, pol, prompt, toks):
    """The top-2 logit gap of the one-device model after ``prompt`` and
    ``toks`` (teacher-forced)."""
    model = ranks.build(arch, pol)
    seq = np.concatenate([np.asarray(prompt), np.asarray(toks, np.int32)])
    with torch.inference_mode():
        logits, _ = model.prefill(torch.from_numpy(seq[None].astype(
            np.int64)), 64)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def test_meshed_streams_equal_one_device(mesh_run):
    """Each case (the JAX meshed test's five and qwen2 under fp32 on dense
    rings): the 2x2 engine emits the one-device engine's streams; a
    divergence passes only at a top-2 logit tie (gap under ``TIE_GAP`` at
    its first token). Under ``mirage_rrns`` the ranks draw the one-device
    noise, and the analog-health counters summed over them, and the
    metrics exporter's ``serve_health_*`` gauges, are the one device's.
    One test for the six cases: a file of fewer than 9 tests is handed out
    after the JAX package's slowest file."""
    for case in ranks.CASES:
        got = mesh_run.cases[case]
        assert len(got["meshed"]) == 6, case
        prompts = {r.rid: r.prompt for r in ranks.requests(
            ranks.build(*case[:2]).cfg)}
        for rid, want in got["single"].items():
            have = got["meshed"][rid]
            if have == want:
                continue
            t = next(i for i, (a, b) in enumerate(zip(want, have))
                     if a != b)
            gap = _first_gap(case[0], case[1], prompts[rid], want[:t])
            assert gap < TIE_GAP, (case, rid, t, gap, want, have)
        assert got["health"] == got["single_health"], case
        # the metrics exporter reads the summed counts, no collective
        assert got["exported"] == got["single_exported"], case
        if case[1] == "mirage_rrns":
            assert got["health"]["rrns_uncorrected"] == 0
            assert sum(got["health"]["detector_flips"]) > 0


def test_one_device_port_engine_equals_jax(mesh_run):
    """The reference of the meshed gate: the single-device port engine's
    streams equal the JAX engine's on the same weights and requests, in
    every case but mirage_rrns (qwen2, mixtral, mamba2 and zamba2 under
    mirage, qwen2 under fp32)."""
    for case in JAX_CASES:
        assert mesh_run.cases[case]["single"] == mesh_run.jax[case], case


def test_sampled_streams_equal_one_device(mesh_run):
    """Sampled decode (``greedy=False``, qwen2 mirage, paged) on the mesh:
    each data rank draws the one-device tick's sampling numbers and keeps
    its slots' rows, so the streams are the one device's (and not the
    greedy ones)."""
    s = mesh_run.cases["sampled"]
    assert len(s["meshed"]) == 6
    assert s["meshed"] == s["single"]
    assert s["single"] != mesh_run.cases[ranks.CASES[0]]["single"]


def test_meshed_paged_allocator_is_sharded(mesh_run):
    """The JAX test's assertions: two block shards, allocations local under
    ``locality``, nothing spilled, no remote reference; the allocator's
    invariants held (on the rank); each rank holds half the slots and half
    the pool (plus its scratch rows) at one kv head, and no page moved."""
    a = mesh_run.cases["alloc"]
    assert a["n_shards"] == 2
    assert a["local"] > 0
    assert a["spilled"] == 0
    assert a["remote"] == 0.0
    assert a["exchanged"] == 0
    assert a["local_slots"] == (2,)
    # (layers, 16 blocks + 2 slots x 4 scratch rows, block, kv heads, hd)
    assert a["local_pool"] == (4, 24, 16, 1, 16)


def test_round_robin_prefix_chunk_spec_on_mesh(mesh_run):
    """Blocks placed ``round_robin`` (half of every slot's pages on the
    other shard), chunked prefill, prefix hits across shards and
    speculative verify ticks: the one-device streams, the pages moved
    counted in ``page_exchange``."""
    o = mesh_run.cases["options"]
    assert o["meshed"] == o["single"]
    assert o["hits"] > 0
    assert o["spec_ticks"] > 0
    assert o["exchanged"] > 0


def test_snapshots_cross_between_mesh_and_one_device(mesh_run):
    """A snapshot of the meshed engine (mirage_rrns at 52 dB, 4 ticks in)
    restored on one device, and one of a one-device engine restored on the
    mesh, each resume the uninterrupted streams, noise included."""
    s = mesh_run.load("snapshots.pt")
    assert s["mesh_to_one"] == s["whole"]
    assert s["one_to_mesh"] == s["whole"]


def test_distributed_launcher_prints_one_device_streams(mesh_run, capsys):
    """``launch.serve --distributed --mesh-data 2 --mesh-model 2`` in the
    spawned ranks: rank 0 prints the mesh, two block shards and the
    one-device launcher's streams; the other ranks print nothing."""
    serve.main(ranks.LAUNCH + ["--device", "cpu"])
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.strip().startswith("req ")]
    with open(os.path.join(mesh_run.dir, "launch_0.txt")) as f:
        text = f.read()
    have = [ln for ln in text.splitlines() if ln.strip().startswith("req ")]
    assert want and have[:len(want)] == want
    assert "mesh: data=2 x model=2 over gloo" in text
    assert "block shards: 2 (locality)" in text
    for r in (1, 2, 3):
        with open(os.path.join(mesh_run.dir, f"launch_{r}.txt")) as f:
            assert f.read() == ""


def test_warmup_and_pipelining_refuse_on_a_mesh(mesh_run):
    """The two options a mesh refuses, each naming its ROADMAP item."""
    r = mesh_run.load("refusals.pt")
    assert "slice 8c" in r["warmup"]
    assert "slice 8c" in r["pipeline"]
