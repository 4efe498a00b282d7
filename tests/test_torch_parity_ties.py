"""PyTorch port: where greedy parity with the JAX package breaks, and why.

``tests/test_torch_server_paged.py::test_dense_and_oracle_equal_jax_engine``
serves the ``mixed`` workload (reduced qwen2-0.5b under ``mirage``,
``q_chunk = kv_chunk = 16``, the JAX init's weights). Request 3's prompt (8
tokens, numpy seed 0) is prefilled at its own length by the per-slot oracle
and padded to 16 by the batched engines. Both packages compute the same two
logit vectors for it, one at each length, but attach them to opposite
lengths. These tests pin where that comes from:

- kernel 1's plain version equals the JAX GEMM route bit for bit at M = 8
  and M = 16, at every GEMM of the model;
- layers 0 and 1 equal JAX's bit for bit at both lengths;
- in layer 2 the attention context (the o-projection's input, before its
  BFP quantization) agrees with JAX's within f32 rounding, and exactly one
  element quantizes differently: it is -0.1875, a rounding midpoint of its
  group's grid (round half to even), in one package and -0.18749999 in
  the other, so the o-projection's inputs differ by one grid step. JAX's
  context holds the midpoint at L = 8, the port's at L = 16.

The f32 differences below the grid come from code each framework picks
for itself. The rope is one cause: XLA's CPU code contracts
``x1 * cos - x2 * sin`` into ``fma(x1, cos, -(x2 * sin))`` and takes cos
and sin from its own routines, so the port's rotated q and k differ from
JAX's in the last bit at many elements; giving the port's rope that FMA
made this case pass and broke another engine's (``[mixed-paged_chunk]``),
so it was not kept. The dot and softmax routines, whose summation order
changes with the chunk shape min(q_chunk, L), are the others.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.gemm import mirage_matmul_auto as jmatmul
from repro.core.precision import get_policy as jpolicy
from repro.models import attention as jattention
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models.lm import LMCallOptions as JOptions
from repro_torch.configs import get_config
from repro_torch.core import bfp
from repro_torch.core.gemm import mirage_matmul_auto
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import attention, build_model
from repro_torch.models.lm import LMCallOptions

ARCH = "qwen2-0.5b"
OPTS = dict(q_chunk=16, kv_chunk=16)
#: the tie's layer (layers before it agree bit for bit)
TIE_LAYER = 2


@pytest.fixture(scope="module")
def models():
    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(**OPTS))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).reduced(), get_policy("mirage"),
                     LMCallOptions(**OPTS), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return cfg, params, tm


def _prompt(L):
    """Request 3 of the ``mixed`` workload, right-padded with 0 to L."""
    rng = np.random.default_rng(0)
    prompt = [rng.integers(0, 256, [8, 11, 6][i % 3]).astype(np.int32)
              for i in range(4)][3]
    out = np.zeros(L, np.int32)
    out[:8] = prompt
    return out


def _jax_hidden(cfg, params, n_layers, toks):
    """JAX's hidden state after its first ``n_layers`` layers."""
    jm = jbuild(dataclasses.replace(cfg, n_layers=n_layers),
                jpolicy("mirage"), JOptions(**OPTS))
    head = dict(params, layers=jax.tree_util.tree_map(
        lambda a: a[:n_layers], params["layers"]))
    return np.asarray(jax.jit(lambda p, t: jm.forward_hidden(p, t)[0])(
        head, toks[None]))


@pytest.mark.parametrize("M", [8, 16])
def test_gemm_plain_equals_jax_route_at_both_lengths(models, M):
    cfg, params, tm = models
    rng = np.random.default_rng(M)
    jgemm = jax.jit(lambda x, w: jmatmul(x, w, jpolicy("mirage")))
    weights = [m.w for name, m in tm.named_modules() if hasattr(m, "w")]
    weights.append(tm.embed.emb.T)
    for w in weights:
        x = rng.standard_normal((M, w.shape[0])).astype(np.float32)
        with torch.no_grad():
            got = mirage_matmul_auto(torch.from_numpy(x), w,
                                     get_policy("mirage"))
        want = jgemm(x, w.detach().numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L", [8, 16])
def test_layers_before_the_tie_equal_jax(models, L):
    cfg, params, tm = models
    toks = _prompt(L)
    with torch.no_grad():
        h = tm.embed.emb[torch.from_numpy(toks).long()][None]
        pos = torch.arange(L)
        for n, layer in enumerate(list(tm.layers)[:TIE_LAYER], start=1):
            h, _, _ = tm._attn_mlp_block(layer, h, pos)
            np.testing.assert_array_equal(
                h.numpy()[0, :8], _jax_hidden(cfg, params, n, toks)[0, :8])


#: the one element of layer 2's attention context, (batch, position,
#: feature), whose BFP quantization differs between the two packages
TIE = (0, 1, 41)
#: which package's context holds the midpoint at each length
ON_MIDPOINT = {8: "jax", 16: "port"}


@pytest.mark.parametrize("L", [8, 16])
def test_divergence_is_a_bfp_midpoint_tie(models, L):
    """Layer 2's attention context from JAX's own layer input and norm:
    the two packages agree within f32 rounding, and the one element whose
    BFP quantization differs is TIE, which sits exactly on a rounding
    midpoint in one package (JAX's at L = 8, the port's at L = 16) and
    one f32 step toward zero from it in the other."""
    cfg, params, tm = models
    toks = _prompt(L)
    h = _jax_hidden(cfg, params, TIE_LAYER, toks)
    lp = jax.tree_util.tree_map(lambda a: a[TIE_LAYER], params["layers"])
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
              skip_o_proj=True, **OPTS)

    def jax_context(lp, h):
        n1 = jcommon.norm(lp["ln1"], h, cfg.norm_eps, cfg.norm_type)
        ctx, _ = jattention.attn_apply(lp["attn"], n1, jpolicy("mirage"),
                                       positions=jnp.arange(L), **kw)
        return n1, ctx

    n1, want = jax.jit(jax_context)(lp, h)
    with torch.no_grad():
        got, _ = attention.attn_apply(
            tm.layers[TIE_LAYER].attn, torch.from_numpy(np.array(n1)),
            get_policy("mirage"), positions=torch.arange(L), **kw)
    want = torch.from_numpy(np.array(want))[:, :8]
    got = got[:, :8]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)

    def midpoints(x):
        _, scale, _ = bfp.bfp_quantize(x, 4, 16)
        v = bfp._group_reshape(x, 16)[0] / scale
        return ((v - torch.floor(v)) == 0.5).reshape(x.shape)

    differ = bfp.bfp_fake_quant(got, 4, 16) != bfp.bfp_fake_quant(want, 4,
                                                                   16)
    assert [tuple(i) for i in differ.nonzero().tolist()] == [TIE]
    on, off = (want, got) if ON_MIDPOINT[L] == "jax" else (got, want)
    assert float(on[TIE]) == -0.1875 and bool(midpoints(on)[TIE])
    assert float(off[TIE]) == float(np.nextafter(np.float32(-0.1875),
                                                 np.float32(0)))
    assert not bool(midpoints(off)[TIE])


def logit_digests():
    """Request 3's last-position logits in both packages, unpadded (L = 8)
    and right-padded to 16 with ``lens = [8]``: the top two tokens with
    their logits, and a sha256 digest of the f32 vector's bytes."""
    import hashlib

    cfg = jconfig(ARCH).reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(**OPTS))
    _, params, tm = models.__wrapped__()
    out = {}
    for L in (8, 16):
        toks = _prompt(L)
        lens = None if L == 8 else [8]
        jl, _ = jm.prefill(params, jnp.asarray(toks)[None], 24,
                           lens=None if lens is None else jnp.asarray(lens))
        with torch.no_grad():
            tl, _ = tm.prefill(torch.from_numpy(toks)[None], 24,
                               lens=None if lens is None
                               else torch.tensor(lens))
        for pkg, v in (("jax", np.asarray(jl)), ("port", tl.numpy())):
            v = np.ascontiguousarray(v.reshape(-1), np.float32)
            top = np.argsort(-v)[:2]
            out[f"{pkg} L={L}"] = {
                "top2": [(int(i), float(v[i])) for i in top],
                "sha256": hashlib.sha256(v.tobytes()).hexdigest()[:16]}
    return out


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_parity_ties.py
    for key, val in logit_digests().items():
        print(key, val)
