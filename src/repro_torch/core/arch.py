"""Accelerator architecture models for the pre-RTL evaluator.

The paper's DLA (Fig. 1) is parameterised by the PE-array factors
``(F1, F2, F3, F4)`` — F1 output channels x F4 input channels of PE blocks,
each block an F2 x F3 (Hsiao et al. [2]) or F2 x 3 (VWA [3]) array of PEs:

* ``hsiao`` [2]: each PE holds 9 multipliers + an adder tree, i.e. one PE
  retires a full 3x3 kernel window per cycle.
* ``vwa``   [3]: each PE holds 1 multiplier + adder; the block's 3 columns
  stream kernel columns with a 1-D broadcast dataflow.

Energy constants follow Sec. III: ``E_DRAM = 1 nJ`` per word access,
``E_SRAM = 0.1 nJ`` per word access, ``E_PB = 0.01 nJ`` per PE-block cycle.

:class:`GPUSpec` describes the card this package runs its kernels on (an
NVIDIA H100): :func:`gpu_spec` reads the properties CUDA reports and keeps
the data-sheet peaks, which no device query returns.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np

from .errors import ConfigValidationError

# ---------------------------------------------------------------------------
# DLA configurations (the paper's ASIC models)
# ---------------------------------------------------------------------------

ARCH_STYLES = ("hsiao", "vwa")


@dataclasses.dataclass(frozen=True)
class DLAConfig:
    """One point in the paper's hardware configuration space."""

    style: str  # "hsiao" | "vwa"
    f1: int  # output-channel parallel PE blocks
    f2: int  # PE rows per block
    f3: int  # PE cols per block (forced to 3 for vwa)
    f4: int  # input-channel parallel PE blocks

    # E_PE accounting granularity.  "pe_cycle": every PE burns E_PB each busy
    # cycle (under-utilised lanes still clock => ceil-tiling waste costs
    # energy; this is the calibration under which the paper's (4,4,4,4)
    # optimum is reproduced).  "block_cycle": one count per PE *block* cycle.
    pe_energy: str = "pe_cycle"

    # --- micro-architecture constants (documented modeling choices) --------
    dram_words_per_cycle: int = 4  # DRAM bus words/cycle (calibrated, Sec III)
    pipeline_latency: int = 16  # t_PL fill cycles per layer
    mults_per_pe: int = dataclasses.field(init=False, default=0)

    # --- energy (nJ per access / per PE-block-cycle), Sec. III -------------
    e_dram_nj: float = 1.0
    e_sram_nj: float = 0.1
    e_pb_nj: float = 0.01

    # --- area (TSMC 40nm, um^2) ---------------------------------------------
    area_per_mult_um2: float = 600.0  # 8-bit multiplier + share of adder tree
    area_per_pe_overhead_um2: float = 150.0  # regs + control per PE
    area_per_sram_byte_um2: float = 2.5
    area_controller_um2: float = 150_000.0

    def __post_init__(self):
        if self.style not in ARCH_STYLES:
            raise ConfigValidationError(f"unknown style {self.style!r}")
        if self.style == "vwa" and self.f3 != 3:
            raise ConfigValidationError("VWA PE blocks are F2 x 3 (f3 must be 3)")
        if self.pe_energy not in ("pe_cycle", "block_cycle"):
            raise ConfigValidationError(f"unknown pe_energy {self.pe_energy!r}")
        for f in (self.f1, self.f2, self.f3, self.f4):
            if f < 1:
                raise ConfigValidationError("PE factors must be >= 1")
        object.__setattr__(self, "mults_per_pe", 9 if self.style == "hsiao" else 1)

    # ---- compute geometry ---------------------------------------------------
    @property
    def pes_per_block(self) -> int:
        """PEs in one block: the F2 x F3 tile."""
        return self.f2 * self.f3

    @property
    def n_blocks(self) -> int:
        """Block count: F1 output-channel x F4 input-channel tiles."""
        return self.f1 * self.f4

    @property
    def n_pes(self) -> int:
        """Total processing elements across all blocks."""
        return self.n_blocks * self.pes_per_block

    @property
    def macs_per_cycle(self) -> int:
        """Peak MAC throughput (hsiao PEs carry 9 multipliers, vwa 1)."""
        return self.n_pes * self.mults_per_pe

    @property
    def pe_units(self) -> int:
        """E_PE multiplier per busy cycle (see ``pe_energy``)."""
        return self.n_pes if self.pe_energy == "pe_cycle" else self.n_blocks

    # ---- Eq. (2) latency terms ---------------------------------------------
    def pe_busy_cycles(self, *, macs: float, n_in: float, n_out: float,
                       kh: float, kw: float, pixels_out: float) -> float:
        """t_PB with ceil-tiling over the (F1, F4, spatial, kernel) factors.

        hsiao: a PE retires min(kh*kw, 9) MACs/cycle; the F2 x F3 block tiles
        output pixels.  vwa: a PE retires 1 MAC/cycle; the block's 3 columns
        tile the kernel width and F2 rows tile output rows.
        """
        if macs <= 0:
            return 0.0
        co_tiles = math.ceil(n_out / self.f1)
        ci_tiles = math.ceil(n_in / self.f4)
        if self.style == "hsiao":
            px_tiles = math.ceil(pixels_out / (self.f2 * self.f3))
            k_cycles = math.ceil((kh * kw) / 9.0)
        else:
            px_tiles = math.ceil(pixels_out / self.f2)
            k_cycles = kh * math.ceil(kw / 3.0)
        return float(co_tiles * ci_tiles * px_tiles * k_cycles)

    # ---- Eq. (4) area --------------------------------------------------------
    def area_pe_um2(self) -> float:
        """A_PB: the PE-array area term of Eq. (4)."""
        per_pe = self.mults_per_pe * self.area_per_mult_um2 + self.area_per_pe_overhead_um2
        return self.n_pes * per_pe

    def area_um2(self, *, if_sram_words: float, w_sram_words: float,
                 of_sram_words: float, word_bytes: float = 1.0) -> float:
        """A = A_PB + A_IFM + A_WB + A_OFM (+ controller), Eq. (4)."""
        sram_bytes = (if_sram_words + w_sram_words + of_sram_words) * word_bytes
        return (
            self.area_pe_um2()
            + sram_bytes * self.area_per_sram_byte_um2
            + self.area_controller_um2
        )

    # ---- vectorisation helper -----------------------------------------------
    def as_row(self) -> np.ndarray:
        """Numeric row for the batched sweep (style encoded as mults_per_pe)."""
        return np.asarray(
            [
                self.f1,
                self.f2,
                self.f3,
                self.f4,
                self.mults_per_pe,
                self.dram_words_per_cycle,
                self.pipeline_latency,
                self.e_dram_nj,
                self.e_sram_nj,
                self.e_pb_nj,
                self.pe_units,
            ],
            dtype=np.float64,
        )

    ROW_FIELDS = (
        "f1", "f2", "f3", "f4", "mults_per_pe", "dram_words_per_cycle",
        "pipeline_latency", "e_dram_nj", "e_sram_nj", "e_pb_nj", "pe_units",
    )

    def describe(self) -> str:
        """One-line human-readable summary of the design point."""
        return (
            f"{self.style}(F1={self.f1},F2={self.f2},F3={self.f3},F4={self.f4})"
            f" {self.macs_per_cycle} MAC/cyc {self.n_pes} PEs"
        )


def default_config_space(
    *,
    styles: Sequence[str] = ARCH_STYLES,
    factors: Sequence[int] = (2, 4, 8, 16),
) -> list[DLAConfig]:
    """The predefined configuration set the optimisation flow sweeps."""
    out: list[DLAConfig] = []
    for style in styles:
        f3s = (3,) if style == "vwa" else factors
        for f1, f2, f3, f4 in itertools.product(factors, factors, f3s, factors):
            out.append(DLAConfig(style, f1, f2, f3, f4))
    return out


# SRAM banking presets for the design-space grid: splitting the frame
# buffers into more banks shortens bitlines/wordlines, cutting per-access
# energy (classic CACTI scaling; the paper's Sec. III constant 0.1 nJ is
# the unified calibration).  Only ``e_sram_nj`` varies — area constants
# stay shared across the space, which the sweep requires
# (:func:`repro_torch.core.metrics.area_consts_of_space`).
SRAM_SPLITS = {
    "unified": 0.1,
    "banked2": 0.07,
    "banked4": 0.05,
}


def config_space_grid(
    *,
    styles: Sequence[str] = ARCH_STYLES,
    f1s: Sequence[int] = (2, 4, 8, 16),
    f2s: Sequence[int] = (2, 4, 8, 16),
    f3s: Sequence[int] = (2, 4, 8, 16),
    f4s: Sequence[int] = (2, 4, 8, 16),
    bus_widths: Sequence[int] = (2, 4, 8, 16),
    sram_splits: Sequence[str] = ("unified", "banked4"),
    pe_energy: str = "pe_cycle",
) -> list[DLAConfig]:
    """Parameterised design-space generator: PE-array shape x SRAM split x
    DRAM bus width -> thousands of :class:`DLAConfig` points (2560 with the
    defaults: hsiao 4^4 + vwa 4^3 PE shapes, x4 bus widths, x2 SRAM splits).

    ``bus_widths`` sets ``dram_words_per_cycle`` and should stay powers of
    two: every latency division is then exact in float64, preserving the
    sweep's bit-identity to the scalar oracles.  ``sram_splits`` are
    :data:`SRAM_SPLITS` preset names varying the per-access SRAM energy;
    area constants are deliberately NOT varied (the sweep shares one
    area-consts vector across the hardware batch).  vwa PE blocks are
    F2 x 3 by construction, so ``f3s`` applies to hsiao only.
    """
    out: list[DLAConfig] = []
    for style in styles:
        s_f3s = (3,) if style == "vwa" else f3s
        for split in sram_splits:
            if split not in SRAM_SPLITS:
                raise ConfigValidationError(
                    f"unknown SRAM-split preset {split!r}; "
                    f"valid presets: {sorted(SRAM_SPLITS)}")
            e_sram = SRAM_SPLITS[split]
            for bus in bus_widths:
                for f1, f2, f3, f4 in itertools.product(f1s, f2s, s_f3s, f4s):
                    out.append(
                        DLAConfig(
                            style, f1, f2, f3, f4,
                            pe_energy=pe_energy,
                            dram_words_per_cycle=bus,
                            e_sram_nj=e_sram,
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# Constraints (Sec. II-C / Sec. III)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Constraints:
    """User constraints checked by the optimisation flow (paper Sec. III)."""

    max_bandwidth_words: float = 20e6  # 20 M bytes (1 word = 1 byte)
    max_latency_cycles: float = 12e6  # 12 M cycles
    max_energy_nj: float = 65e6  # 65 mJ
    max_area_um2: float = 45e6  # 45,000,000 um^2

    def as_row(self) -> np.ndarray:
        """The four bounds as a float64 row, metric order of Eq. (1)-(4)."""
        return np.asarray(
            [
                self.max_bandwidth_words,
                self.max_latency_cycles,
                self.max_energy_nj,
                self.max_area_um2,
            ],
            dtype=np.float64,
        )


PAPER_CONSTRAINTS = Constraints()
PAPER_OPTIMAL_CONFIG = DLAConfig("hsiao", 4, 4, 4, 4)


def paper_config_space() -> list[DLAConfig]:
    """The paper's 'predefined configuration set' (Sec. III).

    The paper does not list the set; uniform-factor configurations
    (F,F,F,F) per style are the natural reading under which its stated
    optimum (4,4,4,4) is the unique feasible min-energy point: (2,2,2,2)
    violates the 12 M-cycle latency bound, (16,16,16,16) the 45 mm^2 area
    bound, (8,8,8,8) is feasible but spends more PE energy on ceil-tiling
    waste, and every VWA point violates the 65 mJ energy bound.
    """
    out = [DLAConfig("hsiao", f, f, f, f) for f in (2, 4, 8, 16)]
    out += [DLAConfig("vwa", f, f, 3, f) for f in (2, 4, 8, 16)]
    return out


# ---------------------------------------------------------------------------
# GPU target (the card this package runs its kernels on)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Per-card limits the kernels are sized and bounded against.

    ``source`` says where the device fields came from: ``"device"`` when
    read from ``torch.cuda.get_device_properties``, ``"datasheet"`` when
    they are NVIDIA's published H100 SXM values.  The peak rates are always
    data-sheet values (dense, at the full 700 W power limit): a card set
    to a lower power limit runs slower under load.

    ``link_bw`` is the interconnect term of the step roofline
    (:mod:`repro_torch.core.roofline`): NVLink 4 on the H100 SXM moves 900
    GB/s in total, 450 GB/s each way, and a collective's output bytes are
    divided by the 450 GB/s one direction carries.  :attr:`peak_flops` is
    the one peak the roofline's compute term uses, the dense bfloat16 rate.
    """

    name: str = "NVIDIA H100 SXM (datasheet)"
    sm_count: int = 132
    smem_per_block_optin: int = 232_448  # 227 KB of the SM's 256 KB
    hbm_bytes: int = 80 * 10**9
    hbm_bw: float = 3.35e12  # bytes/s
    peak_fp32_flops: float = 67e12  # CUDA cores, no tensor cores
    peak_bf16_flops: float = 989e12  # tensor cores, dense
    peak_tf32_flops: float = 494.7e12  # tensor cores, dense TF32
    link_bw: float = 450e9  # bytes/s, NVLink 4, one direction of 900 GB/s
    source: str = "datasheet"

    @property
    def peak_flops(self) -> float:
        """The roofline's compute peak: dense bfloat16 on the tensor cores."""
        return self.peak_bf16_flops

    def compute_seconds(self, flops: float, dtype_bytes: int = 4) -> float:
        """Compute-bound time at the peak rate for the operand type."""
        peak = self.peak_fp32_flops if dtype_bytes == 4 else self.peak_bf16_flops
        return flops / peak

    def tf32x3_seconds(self, flops: float) -> float:
        """Compute-bound time of float32-exact work done as 3xTF32: three
        TF32 tensor-core products per multiply-add."""
        return 3 * flops / self.peak_tf32_flops

    def memory_seconds(self, n_bytes: float) -> float:
        """Memory-bound time at peak device-memory bandwidth."""
        return n_bytes / self.hbm_bw


H100 = GPUSpec()


def gpu_spec(device: "int | str | None" = None) -> GPUSpec:
    """The card's :class:`GPUSpec`: name, SM count, opt-in shared memory
    per block and device memory from CUDA when it is present, otherwise
    the data-sheet :data:`H100`."""
    import torch

    if not torch.cuda.is_available():
        return H100
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device
    )
    return dataclasses.replace(
        H100,
        name=props.name,
        sm_count=props.multi_processor_count,
        smem_per_block_optin=int(
            getattr(props, "shared_memory_per_block_optin",
                    H100.smem_per_block_optin)
        ),
        hbm_bytes=int(props.total_memory),
        source="device",
    )
