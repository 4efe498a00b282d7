"""Mamba2 (SSD, state-space duality) block: chunked scan and O(1) decode
(port of ``repro.models.mamba2``).

Follows Dao & Gu (arXiv:2405.21060) with n_groups = 1 (the 2.7B config): the
sequence runs in chunks of Q tokens; inside a chunk the quadratic
"attention-like" form, between chunks a (H, P, N) state carried by a Python
loop (the JAX package's ``lax.scan``), so memory stays O(B * Q^2 * H)
whatever L is, and the same recurrence gives the single-token decode step.

The projections (``in_proj``, ``out_proj``) go through the Mirage GEMM
(``common.dense``: kernel 1, or kernels 4-6 under the RNS modes); the SSD
recurrence is elementwise and small-contraction f32 state math in plain
PyTorch, as it is plain ``jnp`` in the JAX package (no Pallas kernel).

Where the bits can differ, the JAX formulas are kept: softplus is
``logaddexp(x, 0)`` (``jax.nn.softplus``; ``F.softplus``'s threshold
rounds otherwise), the decay matrix masks before ``exp``, the prefill conv
sums its K shifted views in order and adds the bias last while the decode
conv contracts its (B, K, C) window, and the SSD einsums run as explicit
contractions that never materialize a (B, Q, K, H, P) product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import MiragePolicy
from repro_torch.models import common


class Mamba(nn.Module):
    """One Mamba2 block's parameters (n_groups = 1), in the JAX tree's
    names: ``in_proj`` (d -> [z, x, B, C, dt]), ``conv_w`` (K, conv_dim),
    ``conv_b``, ``A_log``, ``D``, ``dt_bias``, the gated ``norm`` and
    ``out_proj``. Initialized as the JAX ``mamba_init``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        d, d_inner = cfg.d_model, cfg.d_inner
        H, N = cfg.ssm_heads, cfg.ssm_state
        conv_dim = d_inner + 2 * N      # x, B, C share the causal conv
        kw = dict(generator=generator, device=device)
        # order: [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        self.in_proj = common.Dense(d, 2 * d_inner + 2 * N + H, **kw)
        self.conv_w = nn.Parameter(torch.randn(
            (cfg.ssm_conv, conv_dim), generator=generator, device=device)
            * 0.2)
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=device))
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, H + 1, dtype=torch.float32, device=device)))
        self.D = nn.Parameter(torch.ones(H, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(H, device=device))
        self.norm = common.Norm(d_inner, device=device)
        self.out_proj = common.Dense(d_inner, d, **kw)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(z_x_b_c_dt: torch.Tensor, d_inner: int, N: int
                ) -> Tuple[torch.Tensor, ...]:
    z = z_x_b_c_dt[..., :d_inner]
    x = z_x_b_c_dt[..., d_inner:2 * d_inner]
    B = z_x_b_c_dt[..., 2 * d_inner:2 * d_inner + N]
    C = z_x_b_c_dt[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = z_x_b_c_dt[..., 2 * d_inner + 2 * N:]
    return z, x, B, C, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d. u: (B, L, C); w: (K, C). The K shifted
    views summed in order i = 0..K-1, the bias added last."""
    K, L = w.shape[0], u.shape[1]
    up = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    out = up[:, 0:L, :] * w[0]
    for i in range(1, K):
        out = out + up[:, i:i + L, :] * w[i]
    return out + b


def _segsum_decay(dA: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(sum_{j<m<=i} dA_m) for i >= j else 0. dA: (B, Q, H).
    Returns (B, H, Q, Q). The mask goes in BEFORE ``exp``: masked lanes
    would overflow and poison the gradients."""
    Q = dA.shape[1]
    cs = torch.cumsum(dA, dim=1)                       # (B, Q, H)
    diff = cs[:, :, None, :] - cs[:, None, :, :]       # (B, Qi, Qj, H)
    ii = torch.arange(Q, device=dA.device)
    mask = (ii[:, None] >= ii[None, :])[None, :, :, None]
    Lmat = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    return Lmat.permute(0, 3, 1, 2)                    # (B, H, Q, Q)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh: (B, L, H, P); dt: (B, L, H), post-softplus; A: (H,)
    negative; Bm, Cm: (B, L, N); init_state: (B, H, P, N). Returns (y (B,
    L, H, P), final state (B, H, P, N)).

    Per chunk, the JAX einsums as explicit contractions: ``CB * L`` as (B,
    H, Q, K) scaled by ``dt`` over K, then one batched matmul with x as (B,
    H, K, P) (the diagonal block); C against the carried state as one
    matmul over N (the off-diagonal block); the state update as one
    batched matmul of the decay-weighted x (B, H, P, K) with B (B, 1, K,
    N)."""
    Bt, L, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // Q
    state = init_state if init_state is not None else torch.zeros(
        (Bt, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xh[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dtq * A                                   # (B, Q, H)
        cs = torch.cumsum(dA, dim=1)
        total = cs[:, -1, :]                           # (B, H)
        # intra-chunk (diagonal block): y = (C B^T . L) (dt x)
        CB = torch.matmul(Cq, Bq.transpose(1, 2))      # (B, Q, K)
        M = CB[:, None] * _segsum_decay(dA) * \
            dtq.transpose(1, 2)[:, :, None, :]         # (B, H, Q, K)
        y_diag = torch.matmul(M, xq.permute(0, 2, 1, 3))   # (B, H, Q, P)
        # inter-chunk: the carried state's contribution
        y_off = torch.matmul(Cq, state.reshape(Bt, H * P, N).transpose(1, 2)
                             ).reshape(Bt, Q, H, P)
        y_off = y_off * torch.exp(cs)[..., None]
        # state update: decay the old state, absorb this chunk
        decay_to_end = torch.exp(total[:, None, :] - cs)   # (B, Q, H)
        xw = xq * (dtq * decay_to_end)[..., None]          # (B, K, H, P)
        upd = torch.matmul(xw.permute(0, 2, 3, 1), Bq[:, None])  # (B,H,P,N)
        state = state * torch.exp(total)[:, :, None, None] + upd
        ys.append(y_diag.permute(0, 2, 1, 3) + y_off)
    y = torch.cat(ys, dim=1)[:, :L]
    return y, state


def ssd_reference(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """O(L) sequential oracle for tests: the plain recurrence over
    tokens."""
    Bt, L, H, P = xh.shape
    N = Bm.shape[-1]
    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(L):
        x_t, dt_t, B_t, C_t = xh[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        decay = torch.exp(dt_t * A)                    # (B, H)
        state = state * decay[:, :, None, None] + \
            (dt_t[:, :, None] * x_t)[..., None] * B_t[:, None, None, :]
        ys.append(torch.matmul(state, C_t[:, None, :, None])[..., 0])
    return torch.stack(ys, dim=1)


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                policy: MiragePolicy,
                init_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                return_cache: bool = False):
    """The full Mamba2 block over a sequence. x: (B, L, d_model). With
    ``return_cache`` also returns (final ssm state (B, H, P, N), conv state
    (B, K-1, conv_dim) of the raw pre-conv inputs)."""
    Bt, L, _ = x.shape
    d_inner, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, \
        cfg.ssm_headdim
    proj = common.dense(p.in_proj, x, policy)
    z, xi, Bm, Cm, dt = _split_proj(proj, d_inner, N)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    if conv_state is not None:
        conv_src = torch.cat([conv_state, conv_in], dim=1)
        conv = _causal_conv(conv_src, p.conv_w, p.conv_b)[
            :, conv_state.shape[1]:]
    else:
        conv_src = conv_in
        conv = _causal_conv(conv_in, p.conv_w, p.conv_b)
    conv = torch.nn.functional.silu(conv)
    xi = conv[..., :d_inner]
    Bm = conv[..., d_inner:d_inner + N]
    Cm = conv[..., d_inner + N:]
    dt = softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xi.reshape(Bt, L, H, P)
    y, state = ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + p.D[None, None, :, None] * xh
    y = y.reshape(Bt, L, d_inner)
    y = common.norm(p.norm, y * torch.nn.functional.silu(z), cfg.norm_eps)
    out = common.dense(p.out_proj, y, policy)
    if not return_cache:
        return out
    K = cfg.ssm_conv
    T = conv_src.shape[1]
    new_conv_state = conv_src[:, T - (K - 1):, :] if T >= K - 1 else \
        torch.nn.functional.pad(conv_src, (0, 0, K - 1 - T, 0))
    return out, (state, new_conv_state)


def mamba_decode_step(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                      policy: MiragePolicy, ssm_state: torch.Tensor,
                      conv_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, d); ssm_state: (B, H, P, N); conv_state:
    (B, K-1, conv_dim) of RAW (pre-conv) inputs. Returns (out (B, 1, d),
    new ssm state, new conv state), new tensors (the caller writes them
    where they belong)."""
    Bt = x.shape[0]
    d_inner, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, \
        cfg.ssm_headdim
    proj = common.dense(p.in_proj, x, policy)
    z, xi, Bm, Cm, dt = _split_proj(proj, d_inner, N)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)             # (B, 1, C)
    window = torch.cat([conv_state, conv_in], dim=1)      # (B, K, C)
    conv = torch.sum(window * p.conv_w, dim=1) + p.conv_b
    conv = torch.nn.functional.silu(conv)[:, None, :]
    new_conv_state = window[:, 1:, :]
    xi = conv[..., :d_inner]
    Bm = conv[..., d_inner:d_inner + N][:, 0]
    Cm = conv[..., d_inner + N:][:, 0]
    dt = softplus(dt + p.dt_bias)[:, 0]                   # (B, H)
    A = -torch.exp(p.A_log)
    xh = xi.reshape(Bt, H, P)
    decay = torch.exp(dt * A)                             # (B, H)
    ssm_state = ssm_state * decay[:, :, None, None] + \
        (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
    y = torch.matmul(ssm_state, Cm[:, None, :, None])[..., 0] + \
        p.D[None, :, None] * xh
    y = y.reshape(Bt, 1, d_inner)
    y = common.norm(p.norm, y * torch.nn.functional.silu(z), cfg.norm_eps)
    return common.dense(p.out_proj, y, policy), ssm_state, new_conv_state
