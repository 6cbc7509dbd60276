"""Hardware constants for roofline analysis and the APElink what-if study.

The port's roofline (``launch/dryrun.py``) prices every cell against
``H100_SXM``, one NVIDIA H100 SXM5.  ``TPU_V5E`` is the JAX package's
target; here it serves the modelled fabric only, and the port's dry run
never prices against it.

The paper's §6 next-generation study (PCIe Gen3, 56 Gb/s links) is expressed
here as alternative hardware constant sets so the roofline can be re-run
under "current" vs "next-gen" link assumptions.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip performance envelope used by the three-term roofline."""

    name: str
    peak_flops_bf16: float  # FLOP/s
    hbm_bandwidth: float    # bytes/s
    ici_link_bandwidth: float  # bytes/s per link direction
    ici_links: int          # off-chip torus links per chip
    hbm_bytes: int          # HBM capacity in bytes
    vmem_bytes: int         # on-chip vector memory

    @property
    def ici_aggregate_bandwidth(self) -> float:
        return self.ici_link_bandwidth * self.ici_links


# Primary target: TPU v5e (values fixed by the assignment).
TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    ici_link_bandwidth=50e9,
    ici_links=4,            # 2D torus per pod; the "pod" axis rides DCN/optical
    hbm_bytes=16 * 1024**3,
    vmem_bytes=128 * 1024**2,
)

# The port's target: one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet, SXM5
# column: dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, 80 GB; NVLink 4: 18 links,
# 900 GB/s both directions together, so 25 GB/s a link and direction).  The
# card these constants are held against reports itself as "NVIDIA H100
# 80GB HBM3, 700.00 W" (nvidia-smi's name and power limit); the rates
# assume that full 700 W.  ``vmem_bytes`` is its 50 MB L2.
H100_SXM = ChipSpec(
    name="h100-sxm5",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    ici_link_bandwidth=25e9,
    ici_links=18,
    hbm_bytes=80 * 10**9,
    vmem_bytes=50 * 1024**2,
)

# Paper-era accelerator (Fermi/Kepler-class) at a conservative 40% MFU —
# the ONE modelled compute rate every paper-twin benchmark prices against:
# benchmarks/overlap.py (backward compute behind the bucketed sync) and the
# serving cluster's re-prefill stall model (benchmarks/migration.py gate).
PAPER_GPU_PEAK_FLOPS = 4.0e12
PAPER_GPU_MFU = 0.4
PAPER_GPU_EFF_FLOPS = PAPER_GPU_PEAK_FLOPS * PAPER_GPU_MFU

# ----------------------------------------------------------------------------
# APEnet+ board generations (paper §2.3, §3, §6) — used by the paper-claims
# benchmarks, NOT by the TPU roofline.  Bandwidths in bytes/s.
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ApenetLinkSpec:
    """One APElink channel: N bonded serial lanes + encoding + protocol."""

    name: str
    lanes: int
    lane_gbps: float          # raw line rate per lane (Gbit/s)
    encoding_efficiency: float  # physical coding (8b/10b = 0.8, 128b/130b ~ 0.985)

    @property
    def raw_bandwidth(self) -> float:
        """Raw aggregated line rate, bytes/s (the paper's '28 Gbps' number)."""
        return self.lanes * self.lane_gbps * 1e9 / 8.0

    @property
    def channel_bandwidth(self) -> float:
        """Post-encoding channel payload capacity, bytes/s (~2.8 GB/s @28Gbps)."""
        return self.raw_bandwidth * self.encoding_efficiency


# Paper operating point: 4 lanes x 7.0 Gbps, 8b/10b -> 2.8 GB/s channel;
# after APElink protocol efficiency 0.784 -> ~2.2 GB/s observed (Fig 3c).
APELINK_28G = ApenetLinkSpec("apelink-28g", lanes=4, lane_gbps=7.0,
                             encoding_efficiency=0.8)
# §6 next-gen: Stratix V, 4 x 14.1 Gbps, QSFP+ (64b/66b-class encoding).
APELINK_56G = ApenetLinkSpec("apelink-56g", lanes=4, lane_gbps=14.1,
                             encoding_efficiency=64.0 / 66.0)
# §6 preliminary measurement: 11.3 Gbps/lane over 40G-certified cables.
APELINK_45G = ApenetLinkSpec("apelink-45g-meas", lanes=4, lane_gbps=11.3,
                             encoding_efficiency=64.0 / 66.0)


@dataclasses.dataclass(frozen=True)
class HostIfSpec:
    """PCIe host interface generations (paper §2.1 / §6)."""

    name: str
    lanes: int
    lane_gbps: float
    encoding_efficiency: float

    @property
    def raw_bandwidth(self) -> float:
        return self.lanes * self.lane_gbps * 1e9 / 8.0

    @property
    def effective_bandwidth(self) -> float:
        return self.raw_bandwidth * self.encoding_efficiency


PCIE_GEN2_X8 = HostIfSpec("pcie-gen2-x8", 8, 5.0, 0.8)           # 4.0 GB/s
PCIE_GEN3_X8 = HostIfSpec("pcie-gen3-x8", 8, 8.0, 128.0 / 130.0)  # ~7.9 GB/s
