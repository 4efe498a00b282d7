"""The mesh's process groups, its collectives, and their autograd rules.

:class:`MeshComm` holds one rank's view of a
:class:`torch.distributed.device_mesh.DeviceMesh`: its coordinate on each
axis, the groups of the ``data`` and ``model`` axes (``dp``: the batch
axes, ``pod`` and ``data`` flattened), and the collectives every sharded
layer calls. Each collective adds its bytes (the unsharded tensor's size)
and its host-clock seconds to :attr:`MeshComm.stats` under its kind
(``all_reduce``, ``all_gather``, ``reduce_scatter``). The axes are
``data``, ``model`` and ``pod``, ``dp`` (the batch axes) and ``world``
(every rank).

Ranks that share one card run over gloo, whose collectives take CUDA
tensors for ``all_reduce`` and ``broadcast`` only. There the all-gather and
the reduce-scatter stage their tensors through pinned host memory
explicitly (a device-to-host copy, the collective on the host, a
host-to-device copy): the cost of ranks sharing a card, not a fallback;
every GEMM stays on the card. Under NCCL nothing is staged.

The autograd rules are Megatron's, written out:

  * :func:`copy_to_tp` (``f``): identity forward, all-reduce over ``model``
    backward: the input of a column-parallel GEMM, whose dX is a partial
    sum on each rank.
  * :func:`reduce_from_tp` (``g``): all-reduce over ``model`` forward,
    identity backward: the output of a row-parallel GEMM (or of any
    partial sum whose consumers are replicated).
  * :func:`gather_dp`: all-gather over ``data`` forward, reduce-scatter
    (sum) backward: a weight sharded at rest (FSDP, ZeRO-3), gathered where
    a layer uses it; its gradient comes back summed over the data ranks on
    the shard the rank owns.
  * :func:`select_tp`: a slice of a tensor replicated over ``model``
    forward; backward, each rank's slice gradient scattered into zeros and
    summed over ``model``.
  * :func:`gather_tp`: all-gather over ``model`` forward, the rank's own
    slice backward (full logits from a vocab-sharded head).
  * :func:`mean_over_dp`: the mean over the batch axes forward, identity
    backward (a global statistic whose consumers are replicated: the MoE
    router's load-balancing means).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "reduce_scatter")


class CommStats:
    """Bytes, seconds and calls by collective kind since :meth:`reset`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = collections.Counter({k: 0 for k in KINDS})
        self.seconds = collections.Counter({k: 0.0 for k in KINDS})
        self.calls = collections.Counter({k: 0 for k in KINDS})

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.bytes[kind] += nbytes
        self.seconds[kind] += seconds
        self.calls[kind] += 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"bytes": int(self.bytes[k]),
                    "seconds": float(self.seconds[k]),
                    "calls": int(self.calls[k])} for k in KINDS}


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A device tensor's copy in pinned host memory (one device-to-host
    copy; the caching host allocator keeps the pinned blocks)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


class MeshComm:
    """One rank's groups and collectives on ``mesh`` (a ``DeviceMesh``
    named ``data``/``model``, led by ``pod`` on a multi-pod mesh)."""

    def __init__(self, mesh, device: Optional[torch.device] = None):
        from repro_torch.parallel import sharding

        self.mesh = mesh
        self.sizes = sharding.mesh_sizes(mesh)
        names = tuple(mesh.mesh_dim_names)
        coord = mesh.get_coordinate()
        self.coord = dict(zip(names, coord))
        self.groups = {n: mesh.get_group(n) for n in names}
        self.tp = self.sizes.get("model", 1)
        self.tp_rank = self.coord.get("model", 0)
        self.n_data = self.sizes.get("data", 1)
        self.data_rank = self.coord.get("data", 0)
        self.dp = self.n_data * self.sizes.get("pod", 1)
        # the rank's coordinate along the flattened batch axes (pod, data):
        # the row-major order in which the global batch is laid out
        self.dp_rank = self.coord.get("pod", 0) * self.n_data + \
            self.data_rank
        if "pod" in names:
            self.groups["dp"] = mesh["pod", "data"]._flatten("dp") \
                .get_group()
        else:
            self.groups["dp"] = self.groups.get("data")
        self.groups["world"] = None         # the default group: every rank
        self.device = torch.device(device) if device is not None else None
        self.backend = dist.get_backend()
        self.stats = CommStats()

    # ------------------------------------------------------------------
    # raw collectives (no autograd)
    # ------------------------------------------------------------------

    def size(self, axis: str) -> int:
        if axis == "world":
            return self.mesh.size()
        return self.dp if axis == "dp" else self.sizes.get(axis, 1)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A new tensor: ``t`` reduced over ``axis`` (every rank of the
        group gets the same values)."""
        out = t.detach().clone().contiguous()
        if self.size(axis) == 1:
            return out
        t0 = time.perf_counter()
        dist.all_reduce(out, op=op, group=self.groups[axis])
        self.stats.add("all_reduce", out.numel() * out.element_size(),
                       time.perf_counter() - t0)
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The group's shards of ``t`` concatenated along ``dim`` in
        coordinate order."""
        n = self.size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = torch.movedim(t.detach(), dim, 0).contiguous()
        dev = src.device
        if self._staged(src):
            src = _to_pinned(src)
        out = torch.empty((n * src.shape[0],) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.groups[axis])
        # contiguous: the GEMM kernel reads a (K, N) weight, its transpose,
        # or a stack of either, not any other strides
        out = torch.movedim(out.to(dev), 0, dim).contiguous()
        self.stats.add("all_gather", out.numel() * out.element_size(),
                       time.perf_counter() - t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0
                       ) -> torch.Tensor:
        """The sum of ``t`` over the group, cut along ``dim`` into equal
        parts in coordinate order: the rank's own part."""
        n = self.size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = torch.movedim(t.detach(), dim, 0).contiguous()
        dev = src.device
        if self._staged(src):
            src = _to_pinned(src)
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.groups[axis])
        nbytes = src.numel() * src.element_size()
        out = torch.movedim(out.to(dev), 0, dim).contiguous()
        self.stats.add("reduce_scatter", nbytes, time.perf_counter() - t0)
        return out

    def chunk(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's equal part of ``t`` along ``dim`` over ``axis``."""
        n = self.size(axis)
        if n == 1:
            return t
        r = self.dp_rank if axis == "dp" else self.coord.get(axis, 0)
        return torch.chunk(t, n, dim=dim)[r]

    def barrier(self) -> None:
        dist.barrier()


# --------------------------------------------------------------------------
# autograd rules
# --------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, "model"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(w, "data", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, "data", ctx.dim), None, None


class _SelectTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, index):
        ctx.comm, ctx.dim, ctx.index = comm, dim, index
        ctx.shape = x.shape
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        full.index_add_(ctx.dim, ctx.index, g)
        return ctx.comm.all_reduce(full, "model"), None, None, None


class _GatherTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.chunk(g, "model", ctx.dim).contiguous(), None, None


class _MeanOverDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x, "dp") / comm.dp

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, comm: Optional[MeshComm]) -> torch.Tensor:
    if comm is None or comm.tp == 1:
        return x
    return _CopyToTP.apply(x, comm)


def reduce_from_tp(x: torch.Tensor, comm: Optional[MeshComm]
                   ) -> torch.Tensor:
    if comm is None or comm.tp == 1:
        return x
    return _ReduceFromTP.apply(x, comm)


def gather_dp(w: torch.Tensor, comm: MeshComm, dim: int) -> torch.Tensor:
    if comm.n_data == 1:
        return w
    return _GatherDP.apply(w, comm, dim)


def select_tp(x: torch.Tensor, comm: MeshComm, dim: int,
              index: torch.Tensor) -> torch.Tensor:
    return _SelectTP.apply(x, comm, dim, index)


def gather_tp(x: torch.Tensor, comm: Optional[MeshComm], dim: int
              ) -> torch.Tensor:
    if comm is None or comm.tp == 1:
        return x
    return _GatherTP.apply(x, comm, dim)


def mean_over_dp(x: torch.Tensor, comm: Optional[MeshComm]) -> torch.Tensor:
    if comm is None or comm.dp == 1:
        return x
    return _MeanOverDP.apply(x, comm)
