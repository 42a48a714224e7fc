"""Performance models.

Port of ``repro.core.perf_model``:

1. The paper's Section-V analytical FPGA model, verbatim:
       T_p    = max(T_comp_max, T_LS)                      (Eq. 18)
       T_comp ~ Eq. 20 (three dominant MXU/DSP terms)
       T_LS   ~ Eq. 21 (four burst-transfer terms)
       thpt   ~ N_b / T_p ; latency ~ (beta - 1 + ceil(N/N_b)) * T_p  (Eq. 22)
   with the paper's two design points (Table IV), ``U200`` and ``ZCU104``.

2. A three-term roofline over a chip spec (``ChipSpec``):
       compute    = FLOPs            / peak FLOP/s of the precision
       memory     = bytes            / device-memory bytes/s
       collective = collective bytes / (links * link bytes/s)
   The port's one chip is ``H100_SXM``, from NVIDIA's published figures;
   ``chip_smoke.py`` takes its kernel bounds from it.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.utils import FrozenConfig


# ---------------------------------------------------------------------------
# Roofline over a chip spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec(FrozenConfig):
    """A chip's published peaks: FLOP/s per precision (dense, no
    sparsity), device-memory bytes/s, bytes/s over its links to the other
    chips, and its device memory."""
    name: str
    fp32_flops: float        # float32 outside the tensor cores
    tf32_flops: float        # TF32 on the tensor cores
    bf16_flops: float        # bf16 on the tensor cores
    hbm_bytes_per_s: float
    link_bytes_per_s: float
    hbm_bytes: float         # device memory

    def peak_flops(self, precision: str) -> float:
        peaks = {"fp32": self.fp32_flops, "tf32": self.tf32_flops,
                 "bf16": self.bf16_flops}
        if precision not in peaks:
            raise ValueError(f"unknown precision {precision!r}; one of "
                             f"{tuple(peaks)}")
        return peaks[precision]


#: NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's H100 data sheet,
#: SXM column; the tensor-core figures there are with sparsity, halved
#: here to the dense rates).
H100_SXM = ChipSpec(
    name="NVIDIA H100 SXM5 80GB, 700 W",
    fp32_flops=67e12,          # H100 SXM5: FP32, 67 TFLOP/s
    tf32_flops=495e12,         # H100 SXM5: TF32 tensor core, 989 sparse
    bf16_flops=989e12,         # H100 SXM5: BF16 tensor core, 1,979 sparse
    hbm_bytes_per_s=3.35e12,   # H100 SXM5: 80 GB HBM3 at 3.35 TB/s
    link_bytes_per_s=900e9,    # H100 SXM5: NVLink 4, 900 GB/s a card
    hbm_bytes=80e9,            # H100 SXM5: 80 GB HBM3
)


@dataclasses.dataclass(frozen=True)
class RooflineTerms(FrozenConfig):
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: perfectly-overlapped max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant term in the no-overlap sum: how close a
        perfectly-overlapped schedule is to the sequential lower bound."""
        s = self.compute_s + self.memory_s + self.collective_s
        return self.step_time_s / s if s > 0 else 0.0


def roofline(flops: float, nbytes: float, collective_bytes: float = 0.0,
             links: int = 1, *, chip: ChipSpec = H100_SXM,
             precision: str = "fp32") -> RooflineTerms:
    """Three-term roofline of one device's work: ``flops`` at
    ``precision``, ``nbytes`` of device memory moved, ``collective_bytes``
    sent over ``links`` of the chip's links."""
    return RooflineTerms(
        compute_s=flops / chip.peak_flops(precision),
        memory_s=nbytes / chip.hbm_bytes_per_s,
        collective_s=collective_bytes / (links * chip.link_bytes_per_s),
    )


def model_flops(n_params: int, n_tokens: int, *, training: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D for a training step (fwd 2ND + bwd 4ND); 2*N*D for
    a pure forward (prefill/decode). For MoE pass the ACTIVE parameter count."""
    return (6.0 if training else 2.0) * n_params * n_tokens


# ---------------------------------------------------------------------------
# Section V — FPGA analytical model (Eq. 18-22)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FPGAConfig(FrozenConfig):
    """Design configuration (Table IV) + model dims (Section V notation)."""
    f_feat: int = 0
    f_mail: int = 372        # message length fed to the GRU (raw, LUT-folded)
    f_mem: int = 100
    f_emb: int = 100
    m_r: int = 10            # neighbor list width (mr)
    n_cu: int = 2            # number of computation units
    s_g: int = 8             # MUU gate array is S_g x S_g
    s_fam: int = 16          # FAM parallelism
    s_ftm: int = 64          # FTM parallelism (8x8)
    n_b: int = 8             # edges per processing batch
    freq_hz: float = 250e6   # F_freq
    bw_bytes: float = 77e9   # peak external bandwidth (U200 DDR4)
    z_d: int = 4             # bytes per element (fp32)
    beta: int = 9            # pipeline stages (Fig. 4)


def alpha_burst(l_elems: int, z_d: int = 4) -> float:
    """Effective-bandwidth factor alpha(l) for burst length l (elements).

    Modeled after the microbenchmarks of Lu et al. [21]: short bursts waste
    DRAM pages; efficiency saturates near 1 for bursts >= ~4KiB.
    """
    bytes_ = max(l_elems, 1) * z_d
    return min(1.0, 0.1 + 0.9 * bytes_ / (bytes_ + 1024.0))


def t_comp_max(cfg: FPGAConfig) -> float:
    """Eq. 20 — dominant compute-stage latency (seconds)."""
    nb = cfg.n_b
    t_muu = 3.0 * nb * cfg.f_mail * cfg.f_mem / (cfg.s_g * cfg.s_g)
    t_fam = 3.0 * nb * cfg.m_r * (cfg.f_mem + cfg.f_feat) / cfg.s_fam
    t_ftm = 3.0 * nb * (cfg.f_mem + cfg.f_feat) * cfg.f_emb / cfg.s_ftm
    return max(t_muu, t_fam, t_ftm) / cfg.freq_hz


def t_ls(cfg: FPGAConfig) -> float:
    """Eq. 21 — load/store latency per processing batch (seconds)."""
    nb, z = cfg.n_b, cfg.z_d
    bw = cfg.bw_bytes
    t1 = 6.0 * nb * cfg.f_mail * z / (alpha_burst(cfg.f_mail, z) * bw)
    t2 = (3.0 * nb * (2 + cfg.m_r) * cfg.f_mem * z
          / (alpha_burst(cfg.f_mem, z) * bw))
    t3 = (3.0 * nb * cfg.m_r * cfg.f_feat * z
          / (alpha_burst(max(cfg.f_feat, 1), z) * bw)) if cfg.f_feat else 0.0
    t4 = 3.0 * nb * cfg.f_emb * z / (alpha_burst(cfg.f_emb, z) * bw)
    return t1 + t2 + t3 + t4


def predict(cfg: FPGAConfig, batch_size: int) -> dict:
    """Eq. 18 & 22: predicted pipeline period, throughput, latency."""
    tp = max(t_comp_max(cfg), t_ls(cfg))
    thpt = cfg.n_b / tp
    latency = (cfg.beta - 1 + math.ceil(batch_size / cfg.n_b)) * tp
    return {"t_p_s": tp, "throughput_eps": thpt, "latency_s": latency,
            "compute_bound": t_comp_max(cfg) >= t_ls(cfg)}


# Published design points (Table IV) for the two boards.
U200 = FPGAConfig(n_cu=2, s_g=8, s_fam=16, s_ftm=64, n_b=8,
                  freq_hz=250e6, bw_bytes=77e9)
ZCU104 = FPGAConfig(n_cu=1, s_g=4, s_fam=8, s_ftm=16, n_b=4,
                    freq_hz=125e6, bw_bytes=19.2e9)
