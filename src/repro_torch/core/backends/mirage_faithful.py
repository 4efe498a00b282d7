"""mirage_faithful: per-group integer dots + FP32 scale-accumulate, as
group-batched products (port of ``repro.core.backends.mirage_faithful``).

Paper dataflow steps 2-9 with the RNS conversions elided, as the paper's
own accuracy model does (Section IV-A). The group axis is the batch axis
of one product, as the photonic core runs the groups in parallel across
MMVMU rows; an expert stack adds the experts to that batch axis (the JAX
package vmaps this backend over them), each expert summing its own
groups. The same code runs on both devices: the JAX package computes
these dots outside any Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

from repro_torch.core.backends import grouped
from repro_torch.core.backends.base import register_fn


@register_fn("mirage_faithful",
             description="group-batched integer dots + FP32 scale-accumulate",
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True,
             supports_batched_weights=True)
def _matmul_mirage_faithful(x, w, policy):
    qx, sx, qw, sw, batch = grouped.prepare_operands(x, w, policy)
    # the scales are powers of two, constant per group: folded into the
    # mantissas BEFORE the dot, every group dot stays exact (== integer dot
    # then scale, bitwise) and the reduction is a plain stacked sum
    out = grouped.grouped_dot(qx * sx, qw * sw, policy.group_block)
    return out.reshape(batch + (out.shape[-1],))
