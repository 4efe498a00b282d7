"""Precision policies for Mirage numerics (port of ``repro.core.precision``).

The paper's operating point is ``b_m = 4, g = 16`` with the special moduli set
``{2^k - 1, 2^k, 2^k + 1}`` for ``k = 5`` -> ``{31, 32, 33}`` (Section V-A).
A :class:`MiragePolicy` bundles everything a GEMM needs to know about the
numerics: mode, BFP parameters, moduli and rounding.

The JAX package's TPU knobs ``use_pallas``/``interpret`` are gone: in the
port the operand's device decides the route (a CUDA tensor launches the
hand-written kernel, a CPU tensor takes its plain PyTorch version).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

GEMM_MODES = (
    "fp32",            # plain f32 matmul (paper's FP32 baseline)
    "bf16",            # bfloat16 matmul, f32 accumulation (bfloat16 baseline)
    "int8",            # per-tensor symmetric int8 (paper's INT8 baseline)
    "mirage_fast",     # BFP quantize -> fold scales -> one matmul
    "mirage_faithful", # BFP quantize -> group-batched integer dots + FP32 acc
    "mirage_rns",      # full RNS path: residue GEMMs per modulus + CRT
    "mirage_rns_pallas",   # mirage_rns forced through the residue kernel
    "mirage_rns_noisy",    # RNS path through the full analog channel model
    "mirage_rrns",         # redundant-RNS path: analog channel + majority decode
    "mirage_faithful_ref", # seed fori_loop faithful path (parity oracle)
    "mirage_rns_ref",      # seed fori_loop RNS path (parity oracle)
    "mirage_rrns_ref",     # pre-fusion RRNS path (oracle)
)

ROUNDING_MODES = ("nearest", "truncate", "stochastic")


def special_moduli(k: int) -> Tuple[int, int, int]:
    """The paper's conversion-friendly three-moduli set {2^k-1, 2^k, 2^k+1}."""
    if k < 2:
        raise ValueError(f"k must be >= 2, got {k}")
    return (2**k - 1, 2**k, 2**k + 1)


def rns_range(moduli: Tuple[int, ...]) -> int:
    """Dynamic range M = prod(m_i). Values live in [-(M-1)//2, (M-1)//2]."""
    return math.prod(moduli)


def required_output_bits(b_m: int, g: int) -> int:
    """Eq. (10): b_out = 2*(b_m + 1) + log2(g) - 1."""
    return 2 * (b_m + 1) + int(math.ceil(math.log2(max(g, 1)))) - 1


def check_overflow_bound(b_m: int, g: int, moduli: Tuple[int, ...]) -> None:
    """Assert Eq. (10): log2(M) >= b_out so group dot products never overflow."""
    M = rns_range(moduli)
    b_out = required_output_bits(b_m, g)
    if math.log2(M) < b_out:
        raise ValueError(
            f"RNS range M={M} (log2={math.log2(M):.2f} bits) cannot hold "
            f"b_out={b_out} bits for b_m={b_m}, g={g} (Eq. 10). "
            f"Increase k or reduce b_m/g."
        )


@dataclasses.dataclass(frozen=True)
class MiragePolicy:
    """Numerics policy applied to every dense GEMM of the model.

    The fields and their validation are those of the JAX package's policy,
    minus ``use_pallas``/``interpret`` (see the module docstring). The
    analog and RNS fields (noise, converters, crosstalk, bursts, redundant
    moduli, group blocking) are read by the ``mirage_rns*`` and
    ``mirage_rrns*`` backends, as in the JAX package.

    Attributes:
      mode: one of GEMM_MODES (or a backend registered in the port).
      b_m: BFP mantissa bits (paper default 4).
      g: BFP group size along the contraction dim (paper default 16).
      k: special-moduli parameter; moduli = {2^k-1, 2^k, 2^k+1} (paper k=5).
      rounding: mantissa rounding, "nearest" (half to even), "truncate" or
        "stochastic" (training only; needs an injected uniform draw).
      compute_dtype: dtype of the folded-scale matmul. BFP(b_m<=6) values
        are exact in bfloat16, so "bfloat16" is value-identical to
        "float32".
      assume_quantized_weights: the weight operand is already on the BFP
        grid (weight-stationary quantization); the GEMM skips its own
        weight-side quantization.
    """

    mode: str = "mirage_fast"
    b_m: int = 4
    g: int = 16
    k: int = 5
    rounding: str = "nearest"
    compute_dtype: str = "float32"
    noise_sigma: float = 0.0
    snr_db: Optional[float] = None
    phase_drift_sigma: float = 0.0
    dac_bits: Optional[int] = None
    adc_bits: Optional[int] = None
    crosstalk: float = 0.0
    burst_rate: float = 0.0
    burst_width: int = 1
    noise_seed: Optional[int] = None
    redundant_moduli: Tuple[int, ...] = ()
    group_block: int = 0
    assume_quantized_weights: bool = False

    def __post_init__(self):
        if self.mode not in GEMM_MODES:
            # lazy import: modes registered with backends.register_fn are
            # valid too (the registry imports this module at load time)
            from repro_torch.core import backends
            if not backends.is_registered(self.mode):
                raise ValueError(
                    f"mode {self.mode!r} not in {GEMM_MODES} and not a "
                    f"registered backend ({backends.available_backends()})")
        if self.rounding not in ROUNDING_MODES:
            raise ValueError(f"rounding {self.rounding!r} not in {ROUNDING_MODES}")
        if self.mode.startswith("mirage"):
            check_overflow_bound(self.b_m, self.g, self.moduli)

    @property
    def moduli(self) -> Tuple[int, int, int]:
        return special_moduli(self.k)

    @property
    def all_moduli(self) -> Tuple[int, ...]:
        return self.moduli + tuple(self.redundant_moduli)

    @property
    def rns_M(self) -> int:
        return rns_range(self.moduli)

    @property
    def psi(self) -> int:
        """Half-range: signed values representable in [-psi, psi]."""
        return (self.rns_M - 1) // 2

    @property
    def mantissa_max(self) -> int:
        """Symmetric (b_m+1)-bit signed mantissa magnitude bound (sign + b_m bits)."""
        return 2**self.b_m - 1

    @property
    def converter_bits(self) -> int:
        """DAC/ADC precision: ceil(log2 m) for the largest modulus (paper: 6b at k=5)."""
        return max(int(math.ceil(math.log2(m))) for m in self.all_moduli)

    def replace(self, **kw) -> "MiragePolicy":
        return dataclasses.replace(self, **kw)


# Canonical policies
PAPER_POLICY = MiragePolicy()  # b_m=4, g=16, k=5 — the paper's chosen point
FP32_POLICY = MiragePolicy(mode="fp32")
BF16_POLICY = MiragePolicy(mode="bf16")
INT8_POLICY = MiragePolicy(mode="int8")
FAITHFUL_POLICY = MiragePolicy(mode="mirage_faithful")
RNS_POLICY = MiragePolicy(mode="mirage_rns")


_POLICY_ALIASES = {"mirage": "mirage_fast"}


def get_policy(name: str, **overrides) -> MiragePolicy:
    """Policy for a mode name (any GEMM_MODES entry or registered backend)."""
    mode = _POLICY_ALIASES.get(name, name)
    base = {
        "fp32": FP32_POLICY,
        "bf16": BF16_POLICY,
        "int8": INT8_POLICY,
        "mirage_fast": PAPER_POLICY,
        "mirage_faithful": FAITHFUL_POLICY,
        "mirage_rns": RNS_POLICY,
    }.get(mode)
    if base is None:
        base = MiragePolicy(mode=mode)  # validates via GEMM_MODES / registry
    return base.replace(**overrides) if overrides else base
