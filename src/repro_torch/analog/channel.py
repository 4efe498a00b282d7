"""Composable analog channel stages of the photonic signal chain (port of
``repro.analog.channel``, paper §IV-B).

Every stage maps a residue tensor ``(n_moduli, ...)`` int32 to one of the
same shape, driven by one :class:`AnalogChannelConfig`:

  program side (stationary operand, once per tile)
    DAC quantization  ->  phase-shifter programming drift
  readout side (per MVM output)
    inter-MMU crosstalk  ->  shot/thermal detector noise  ->  ADC

Detector noise with amplitude SNR ``s`` dB has sigma ``m / 10^(s/20)``
phase levels for modulus ``m`` (the §IV-B "SNR > m" requirement,
``repro_torch.analog.device``).

An expert stack (the MoE layer's residues, ``(n_moduli, E, ...)``) takes
``stack=True``: as under the JAX package's vmap over experts, whose key is
not batched, every stage draws ONCE at one expert's shape and all E
experts reuse the draw, and the crosstalk mixes each expert's own groups.

Randomness: every stochastic stage takes its numbers from a :class:`Draws`
object, one named draw per stage. :class:`GeneratorDraws` serves them in
call order from a ``torch.Generator`` (the serving engine's device
generators); a test can instead replay the exact arrays the JAX package
drew for the same stage names, which is how the two packages are held
bit for bit.

Runtime fault controls (chaos injection, :mod:`repro_torch.runtime.faults`):
:func:`fault_scope` makes a small dict of device tensors ambient
(``sigma_scale``, ``burst_rate``, ``burst_width``, ``stuck_mask``,
``stuck_level``), which the readout stages read as tensors, never as
Python numbers: a step captured as a CUDA graph reads them at their
addresses, and the engine rewrites them in place between replays. Under a
scope the detector noise is drawn even where the config's sigma is zero,
its sigma scaled by ``sigma_scale``; stuck channels are clamped after the
noise; the bursts are drawn at the config's rate plus ``burst_rate``. With
identity controls (:func:`identity_fault_controls`) every stage computes
what it computes without a scope, bit for bit, from the same draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import zlib
from typing import Dict, NamedTuple, Optional, Protocol, Sequence, Tuple

import torch

from repro_torch.obs import health as obs_health


class Draws(Protocol):
    """The random numbers of the stochastic stages. ``stage`` names the
    draw: ``"detector"`` (readout noise), ``"drift"`` (programming drift),
    ``"burst_hit"``, ``"burst_pos"`` and ``"burst_err/<i>"`` (bursts)."""

    def normal(self, stage: str, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard normal f32 of ``shape``."""

    def uniform(self, stage: str, shape: Tuple[int, ...]) -> torch.Tensor:
        """Uniform [0, 1) f32 of ``shape``."""

    def randint(self, stage: str, shape: Tuple[int, ...], low: int,
                high: int) -> torch.Tensor:
        """Integers in [low, high) of ``shape``."""


class GeneratorDraws:
    """:class:`Draws` from one ``torch.Generator``, on its device, in call
    order (the stage names only label the draws). ``bursts``, where given,
    serves the burst stages (``burst_*``) from a generator of their own,
    so that bursts drawn under a fault scope leave the detector noise's
    stream where an unscoped run leaves it."""

    def __init__(self, generator: torch.Generator,
                 bursts: Optional[torch.Generator] = None):
        self.generator = generator
        self.bursts = bursts

    def _gen(self, stage: str) -> torch.Generator:
        if self.bursts is not None and stage.startswith("burst"):
            return self.bursts
        return self.generator

    def normal(self, stage, shape):
        g = self._gen(stage)
        return torch.randn(tuple(shape), generator=g, device=g.device)

    def uniform(self, stage, shape):
        g = self._gen(stage)
        return torch.rand(tuple(shape), generator=g, device=g.device)

    def randint(self, stage, shape, low, high):
        g = self._gen(stage)
        return torch.randint(low, high, tuple(shape), generator=g,
                             device=g.device, dtype=torch.int32)


class SharedDraws:
    """:class:`Draws` that hand every request of one stage and shape the
    same numbers, drawn once from ``draws``: the seed oracles run an expert
    stack one expert at a time and, through this, reuse one draw for all
    of them, as the JAX package's vmap over experts does."""

    def __init__(self, draws: Draws):
        self.draws = draws
        self._memo = {}

    def _get(self, kind, stage, shape, *args):
        key = (kind, stage, tuple(shape)) + args
        if key not in self._memo:
            self._memo[key] = getattr(self.draws, kind)(stage, shape, *args)
        return self._memo[key]

    def normal(self, stage, shape):
        return self._get("normal", stage, shape)

    def uniform(self, stage, shape):
        return self._get("uniform", stage, shape)

    def randint(self, stage, shape, low, high):
        return self._get("randint", stage, shape, low, high)


def seeded_generator(device, *parts) -> torch.Generator:
    """A generator on ``device`` seeded from ``parts`` (ints and strings)
    through crc32, a 32-bit seed: the CPU generator keeps only the low 32
    bits of a seed, so wider mixes would collide there."""
    seed = zlib.crc32("/".join(str(p) for p in parts).encode())
    return torch.Generator(device=device).manual_seed(seed)


# -- runtime fault controls (chaos injection) ----------------------------

_FAULT = threading.local()

#: the control tensors and their dtypes (the JAX package's pytree leaves)
FAULT_CONTROL_DTYPES = {"sigma_scale": torch.float32,
                        "burst_rate": torch.float32,
                        "burst_width": torch.int32,
                        "stuck_mask": torch.bool,
                        "stuck_level": torch.int32}


def fault_control_tensors(values, device=None) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` of the control values ``values`` (numbers,
    lists or numpy values, as :meth:`repro_torch.runtime.faults
    .FaultInjector.controls` returns them)."""
    return {k: torch.as_tensor(values[k], dtype=dtype, device=device)
            for k, dtype in FAULT_CONTROL_DTYPES.items()}


def identity_fault_controls(n_moduli: int,
                            device=None) -> Dict[str, torch.Tensor]:
    """The do-nothing controls of an ``n_moduli``-channel readout: the
    detector sigma unscaled, no extra bursts, no stuck channel."""
    return fault_control_tensors(
        {"sigma_scale": 1.0, "burst_rate": 0.0, "burst_width": 1,
         "stuck_mask": [False] * n_moduli, "stuck_level": [0] * n_moduli},
        device)


@contextlib.contextmanager
def fault_scope(controls: Optional[Dict[str, torch.Tensor]]):
    """Make ``controls`` ambient for the channel stages run inside the
    block, on this thread. ``None`` pushes an inert scope (the stages run
    unfaulted), so call sites can pass through unconditionally."""
    stack = getattr(_FAULT, "stack", None)
    if stack is None:
        stack = _FAULT.stack = []
    stack.append(controls)
    try:
        yield
    finally:
        stack.pop()


def fault_controls() -> Optional[Dict[str, torch.Tensor]]:
    """The innermost active fault controls, or ``None``."""
    stack = getattr(_FAULT, "stack", None)
    return stack[-1] if stack else None


# -- one rank's block of a sharded GEMM (meshed serving) -----------------

_BLOCK = threading.local()

#: the dims of a draw, counted from its end, that a block cuts: the
#: readout stages draw over (..., G, M, N), the programming drift over
#: (..., G, g, N)
_BLOCK_AXES = {"drift": {-3: "groups", -1: "cols"}}
_READOUT_AXES = {-3: "groups", -2: "rows", -1: "cols"}


@contextlib.contextmanager
def block_scope(**parts: Tuple[int, int]):
    """Open while the GEMMs inside compute one rank's block of a GEMM that
    a mesh cuts: ``rows`` (its M, the slots a data rank holds), ``cols``
    (its N, a column-parallel shard) or ``groups`` (its K groups, a
    row-parallel shard), each ``(index, parts)``: the block is the
    ``index``-th of ``parts`` equal parts. Nested scopes add their parts.
    The stochastic stages of such a GEMM draw the whole GEMM's numbers and
    keep their block (:class:`BlockDraws`), so each element sees what the
    one-device engine draws for it."""
    prev = getattr(_BLOCK, "parts", {})
    _BLOCK.parts = {**prev, **{k: v for k, v in parts.items()
                               if v is not None and v[1] > 1}}
    try:
        yield
    finally:
        _BLOCK.parts = prev


def block_parts() -> Dict[str, Tuple[int, int]]:
    """The parts of the innermost :func:`block_scope` ({} outside one)."""
    return getattr(_BLOCK, "parts", {})


class BlockDraws:
    """:class:`Draws` of one block of a sharded GEMM: each request is
    widened along the dims the block cuts (``parts``, as
    :func:`block_scope` holds them), drawn whole from ``draws`` and cut
    back to the block. The generator advances as the whole GEMM's draw
    advances it, so the next GEMM's numbers line up too. Costs the whole
    draw on every rank that holds a block."""

    def __init__(self, draws: Draws, parts: Dict[str, Tuple[int, int]]):
        self.draws = draws
        self.parts = parts

    def _whole(self, stage: str, shape):
        full, cut = list(shape), [slice(None)] * len(shape)
        for ax, name in _BLOCK_AXES.get(stage, _READOUT_AXES).items():
            if name in self.parts and len(shape) >= -ax:
                i, n = self.parts[name]
                full[ax] = shape[ax] * n
                cut[ax] = slice(i * shape[ax], (i + 1) * shape[ax])
        return tuple(full), tuple(cut)

    def _get(self, kind, stage, shape, *args):
        full, cut = self._whole(stage, shape)
        return getattr(self.draws, kind)(stage, full, *args)[cut] \
            .contiguous()

    def normal(self, stage, shape):
        return self._get("normal", stage, shape)

    def uniform(self, stage, shape):
        return self._get("uniform", stage, shape)

    def randint(self, stage, shape, low, high):
        return self._get("randint", stage, shape, low, high)


def block_draws(draws: Optional[Draws]) -> Optional[Draws]:
    """``draws`` cut to the open :func:`block_scope`'s block (``draws``
    itself outside one)."""
    parts = block_parts()
    return BlockDraws(draws, parts) if parts and draws is not None \
        else draws


def detector_sigma_levels(m: int, snr_db: float) -> float:
    """Detector noise sigma in phase-level units for modulus m at SNR (dB)."""
    return m / (10.0 ** (snr_db / 20.0))


@dataclasses.dataclass(frozen=True)
class AnalogChannelConfig:
    """Full analog channel description, one field per physical impairment
    (the JAX package's fields and meanings).

    dac_bits / adc_bits: converter precision; ``None`` = exact
      ``ceil(log2 m)``-bit converters, fewer bits re-grid residues onto
      ``2^bits`` levels.
    snr_db: detector amplitude SNR; sigma ``m / 10^(snr_db/20)`` levels.
    noise_sigma: flat extra sigma (levels), added in quadrature.
    phase_drift_sigma: programming drift on the stationary operand (levels).
    crosstalk: each group channel leaks ``crosstalk`` of each neighbour.
    burst_rate / burst_width: correlated bursts over adjacent channels.
    """

    dac_bits: Optional[int] = None
    adc_bits: Optional[int] = None
    snr_db: Optional[float] = None
    noise_sigma: float = 0.0
    phase_drift_sigma: float = 0.0
    crosstalk: float = 0.0
    burst_rate: float = 0.0
    burst_width: int = 1

    @classmethod
    def from_policy(cls, policy) -> "AnalogChannelConfig":
        return cls(dac_bits=policy.dac_bits, adc_bits=policy.adc_bits,
                   snr_db=policy.snr_db, noise_sigma=policy.noise_sigma,
                   phase_drift_sigma=policy.phase_drift_sigma,
                   crosstalk=policy.crosstalk, burst_rate=policy.burst_rate,
                   burst_width=policy.burst_width)

    @property
    def stochastic(self) -> bool:
        """True when any stage draws random numbers."""
        return (self.snr_db is not None or self.noise_sigma > 0
                or self.phase_drift_sigma > 0 or self.burst_rate > 0)

    def detector_sigmas(self, moduli: Sequence[int]) -> tuple:
        """Per-modulus readout sigma: SNR-derived ⊕ flat, in level units."""
        out = []
        for m in moduli:
            s2 = self.noise_sigma ** 2
            if self.snr_db is not None:
                s2 += detector_sigma_levels(m, self.snr_db) ** 2
            out.append(math.sqrt(s2))
        return tuple(out)


@functools.lru_cache(maxsize=256)
def device_constant(values: Tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """The vector ``values`` on ``device``, made once and kept: a copy from
    the host synchronizes, which the capture of a CUDA graph may not."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _col(values: Sequence[float], ndim: int, dev) -> torch.Tensor:
    return device_constant(tuple(float(v) for v in values), torch.float32,
                           torch.device(dev)).reshape(
                               (-1,) + (1,) * (ndim - 1))


def _wrap(v: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Integer-valued f32 ``v`` (n_mod, ...) wrapped onto each ring, int32."""
    mods = device_constant(tuple(int(m) for m in moduli), torch.int32,
                           v.device).reshape((-1,) + (1,) * (v.dim() - 1))
    return torch.remainder(v.to(torch.int32), mods)


def adc_step(m: int, bits: Optional[int]) -> float:
    """Grid step of a ``bits``-bit converter over [0, m-1]; 0.0 marks the
    identity converter (``bits`` None or ``2^bits >= m``)."""
    if bits is None or 2 ** bits >= m:
        return 0.0
    return (m - 1) / (2 ** bits - 1)


def converter_quantize(residues: torch.Tensor, moduli: Sequence[int],
                       bits: Optional[int]) -> torch.Tensor:
    """Re-grid residues onto the 2^bits uniform levels of a DAC/ADC
    (identity where ``2^bits >= m`` or ``bits`` is None)."""
    if bits is None:
        return residues
    outs = []
    for i, m in enumerate(moduli):
        step = adc_step(m, bits)
        if step == 0.0:
            outs.append(residues[i])
            continue
        # a tensor divisor keeps IEEE division on the card, where PyTorch
        # turns division by a host scalar into a reciprocal multiply
        s = torch.full((), step, dtype=torch.float32,
                       device=residues.device)
        q = torch.round(torch.round(residues[i].to(torch.float32) / s) * s)
        outs.append(torch.clamp(q, 0, m - 1).to(torch.int32))
    return torch.stack(outs, dim=0)


def scaled_sigmas(sigmas: Sequence[float], ctl, ndim: int,
                  dev) -> torch.Tensor:
    """The per-modulus sigmas as an f32 column of ``ndim`` dims, times the
    fault controls' ``sigma_scale`` under a scope (``ctl``; the f32
    product the JAX package forms before scaling its normal draw)."""
    col = _col(sigmas, ndim, dev)
    return col if ctl is None else col * ctl["sigma_scale"]


def draw_noise(residues_shape, sigmas, draws: Draws, device,
               stage: str = "detector", stack: bool = False,
               ctl=None) -> torch.Tensor:
    """Gaussian phase noise for residues of ``residues_shape``, scaled per
    modulus to ``sigmas`` levels (times the fault controls' ``ctl``
    ``sigma_scale``, see :func:`scaled_sigmas`): one draw at one expert's
    shape, with a broadcast expert axis where ``stack``."""
    shape = tuple(residues_shape)
    if stack:
        shape = shape[:1] + shape[2:]
    noise = draws.normal(stage, shape) * scaled_sigmas(sigmas, ctl,
                                                       len(shape), device)
    return noise.unsqueeze(1) if stack else noise


def add_noise(residues: torch.Tensor, moduli: Sequence[int],
              noise: torch.Tensor) -> torch.Tensor:
    """``residues`` plus drawn phase noise, re-quantized to the nearest
    level and wrapped mod m."""
    return _wrap(torch.round(residues.to(torch.float32) + noise), moduli)


def phase_noise(residues: torch.Tensor, moduli: Sequence[int], sigmas,
                draws: Draws, stage: str = "detector",
                stack: bool = False) -> torch.Tensor:
    """Per-modulus additive Gaussian phase noise, re-quantized to the
    nearest level and wrapped mod m (the detector reads phases on a ring).
    An all-zero ``sigmas`` draws nothing."""
    if all(s <= 0 for s in sigmas):
        return residues
    return add_noise(residues, moduli, draw_noise(
        residues.shape, sigmas, draws, residues.device, stage, stack))


def crosstalk_mix(residues: torch.Tensor, moduli: Sequence[int],
                  eps: float, group_axis: int = 1) -> torch.Tensor:
    """Inter-MMU crosstalk: each group channel leaks ``eps`` of each
    neighbouring group (wrapping around the edge); re-quantized and wrapped
    mod m. With one group the mix is the identity."""
    if eps == 0.0 or residues.shape[group_axis] == 1:
        return residues
    r = residues.to(torch.float32)
    if residues.shape[group_axis] == 2:
        # two channels have ONE neighbour each (roll +1 == roll -1)
        mixed = (1.0 - eps) * r + eps * torch.roll(r, 1, dims=group_axis)
    else:
        mixed = ((1.0 - 2.0 * eps) * r
                 + eps * torch.roll(r, 1, dims=group_axis)
                 + eps * torch.roll(r, -1, dims=group_axis))
    return _wrap(torch.round(mixed), moduli)


class Bursts(NamedTuple):
    """The draws of the burst stage over one expert's output elements:
    ``hit`` (bool), the first channel ``start`` and one error per channel
    in ``errs``."""
    hit: torch.Tensor
    start: torch.Tensor
    errs: Tuple[torch.Tensor, ...]

    def block(self, index) -> "Bursts":
        return Bursts(self.hit[index], self.start[index],
                      tuple(e[index] for e in self.errs))


def draw_bursts(shape: Tuple[int, ...], moduli: Sequence[int], rate,
                draws: Draws) -> Bursts:
    """The burst stage's draws over output elements of ``shape``; ``rate``
    a float or a 0-dim f32 tensor (the fault controls)."""
    n = len(moduli)
    return Bursts(draws.uniform("burst_hit", shape) < rate,
                  draws.randint("burst_pos", shape, 0, n),
                  tuple(draws.randint(f"burst_err/{i}", shape, 1, m)
                        for i, m in enumerate(moduli)))


def apply_bursts(residues: torch.Tensor, moduli: Sequence[int], width,
                 b: Bursts, stack: bool = False) -> torch.Tensor:
    """Apply drawn bursts to ``residues (n_mod, ...)``; where ``stack``,
    the draws cover one expert (``residues (n_mod, E, ...)``) and every
    expert takes them. ``width`` an int or a 0-dim int32 tensor. Records
    ``burst_hits`` summed over the experts."""
    n = len(moduli)
    if stack:
        b = Bursts(b.hit[None], b.start[None], tuple(e[None] for e in b.errs))
    if obs_health.active():
        obs_health.record("burst_hits", torch.sum(b.hit) *
                          (residues.shape[1] if stack else 1))
    outs = []
    for i, m in enumerate(moduli):
        in_burst = torch.remainder(i - b.start, n) < width
        outs.append(torch.where(b.hit & in_burst,
                                torch.remainder(residues[i] + b.errs[i], m),
                                residues[i]).to(torch.int32))
    return torch.stack(outs, dim=0)


def burst_errors(residues: torch.Tensor, moduli: Sequence[int], rate,
                 width, draws: Draws) -> torch.Tensor:
    """Correlated bursts: with probability ``rate`` per output element,
    ``width`` ADJACENT residue channels (wrapping at the edge) take uniform
    errors in ``[1, m-1]`` at once. ``rate``/``width`` may be device
    tensors (the fault controls); the zero-rate short cut holds only for a
    number."""
    if not isinstance(rate, torch.Tensor) and rate <= 0:
        return residues
    return apply_bursts(residues, moduli, width, draw_bursts(
        tuple(residues.shape[1:]), moduli, rate, draws))


def _flips(after: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """Per-channel count of residues a stage moved."""
    return torch.sum(after != before, dim=tuple(range(1, after.dim())))


def apply_program_channel(residues: torch.Tensor, moduli: Sequence[int],
                          cfg: AnalogChannelConfig,
                          draws: Optional[Draws],
                          stack: bool = False) -> torch.Tensor:
    """Program-side chain on the stationary operand: DAC -> shifter drift
    (one drift draw for every expert of a stack)."""
    out = converter_quantize(residues, moduli, cfg.dac_bits)
    if cfg.phase_drift_sigma > 0:
        drifted = phase_noise(out, moduli,
                              (cfg.phase_drift_sigma,) * len(moduli), draws,
                              stage="drift", stack=stack)
        if obs_health.active():
            obs_health.record("drift_flips", _flips(drifted, out))
        out = drifted
    return out


def stuck_clamp(residues: torch.Tensor, moduli: Sequence[int],
                ctl) -> torch.Tensor:
    """The fault controls' stuck channels pinned to their levels (mod m)."""
    shape = (-1,) + (1,) * (residues.dim() - 1)
    mask = ctl["stuck_mask"].reshape(shape)
    level = _wrap(torch.remainder(
        ctl["stuck_level"].to(torch.float32).reshape(shape),
        _col(moduli, residues.dim(), residues.device)), moduli)
    return torch.where(mask, level, residues)


def apply_readout_channel(residues: torch.Tensor, moduli: Sequence[int],
                          cfg: AnalogChannelConfig, draws: Optional[Draws],
                          group_axis: int = 1, stack: bool = False,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Readout-side chain: crosstalk -> detector noise -> ADC re-quantize.

    ``stack``: ``residues (n_mod, E, G, M, N)``, the crosstalk along each
    expert's groups and one noise draw for all experts. ``noise``: the
    detector noise already drawn and scaled (by :func:`scaled_sigmas`, the
    fault scope's ``sigma_scale`` included), in place of a draw from
    ``draws``.

    Under an open :func:`fault_scope` the noise stage runs even at zero
    sigma, its sigma scaled by ``sigma_scale`` (the same normal draw, so
    scale 1.0 changes nothing), and the stuck channels are clamped after
    it, the residues the clamp moved counted into ``detector_flips`` a
    second time (the JAX package's order and counts)."""
    if stack:
        group_axis = 2
    ctl = fault_controls()
    out = crosstalk_mix(residues, moduli, cfg.crosstalk, group_axis)
    sigmas = cfg.detector_sigmas(moduli)
    if ctl is not None or any(s > 0 for s in sigmas):
        if noise is None:
            noise = draw_noise(out.shape, sigmas, draws, out.device,
                               stack=stack, ctl=ctl)
        noisy = add_noise(out, moduli, noise)
        if obs_health.active():
            # residues the detector noise moved >= 1 level (what the RRNS
            # decode then has to correct)
            obs_health.record("detector_flips", _flips(noisy, out))
        out = noisy
    if ctl is not None:
        stuck = stuck_clamp(out, moduli, ctl)
        if obs_health.active():
            obs_health.record("detector_flips", _flips(stuck, out))
        out = stuck
    return converter_quantize(out, moduli, cfg.adc_bits)
