"""Time encoders: the cosine encoder (Eq. 6) and the LUT encoder (§III-C).

Port of ``repro.core.time_encode``:

    cosine (teacher / baseline):   Phi(dt) = cos(omega * dt + phi)
    LUT    (student):              Phi(dt) = table[bucket(dt)]

LUT buckets are equal-frequency (quantile) intervals of the empirical dt
distribution, and downstream projections are folded into the table
(``fold_projection``), as the paper precomputes LUT x W products into
on-chip memory. On the GPU the row fetch is an indexed load, not the TPU's
one-hot matmul.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class TimeEncoderConfig(FrozenConfig):
    dim: int = 100            # f_time: encoding width
    n_entries: int = 128      # LUT entries (paper: 128 intervals)


# ---------------------------------------------------------------------------
# Cosine encoder (Eq. 6)
# ---------------------------------------------------------------------------


def init_cosine(cfg: TimeEncoderConfig, device) -> dict:
    """TGN-style init: omega spans decades so different dims see different
    scales. It draws nothing."""
    omega = 1.0 / (10.0 ** np.linspace(0, 9, cfg.dim))
    return {"omega": torch.as_tensor(omega, dtype=torch.float32,
                                     device=device),
            "phi": torch.zeros((cfg.dim,), device=device)}


def cosine_encode(params: dict, dt: torch.Tensor) -> torch.Tensor:
    """Phi(dt) = cos(omega*dt + phi). dt: (...,) -> (..., dim)."""
    dt = dt.to(torch.float32)
    return torch.cos(dt[..., None] * params["omega"] + params["phi"])


# ---------------------------------------------------------------------------
# LUT encoder (§III-C)
# ---------------------------------------------------------------------------


def fit_boundaries(dt_samples: np.ndarray, n_entries: int = 128) -> np.ndarray:
    """Equal-frequency interval boundaries from empirical dt samples.

    Returns ``n_entries - 1`` interior boundaries; bucket(dt) = #boundaries
    <= dt, so bucket indices lie in [0, n_entries).
    """
    dt_samples = np.asarray(dt_samples, np.float64)
    qs = np.linspace(0.0, 1.0, n_entries + 1)[1:-1]
    bounds = np.quantile(dt_samples, qs)
    # strictly increasing (duplicate quantiles happen on discrete dt) — nudge.
    bounds = np.maximum.accumulate(bounds)
    eps = 1e-6 * max(1.0, float(bounds[-1]) if len(bounds) else 1.0)
    for i in range(1, len(bounds)):
        if bounds[i] <= bounds[i - 1]:
            bounds[i] = bounds[i - 1] + eps
    return bounds.astype(np.float32)


def default_dt_samples() -> np.ndarray:
    """Power-law-ish dt samples covering [0, 1e7) — the reference's default
    when no samples are given."""
    return 10.0 ** np.random.RandomState(0).uniform(0, 7, 20000)


def init_lut(generator: torch.Generator, cfg: TimeEncoderConfig, device,
             boundaries: np.ndarray | None = None,
             cosine_params: dict | None = None,
             dt_samples: np.ndarray | None = None) -> dict:
    """LUT encoder params: quantile boundaries and a N(0, 1) table, or,
    given ``cosine_params`` (a teacher's cosine encoder), the cosine
    encoding of each bucket's centre, so the student starts as a
    piecewise-constant copy of the teacher's encoder."""
    if boundaries is None:
        if dt_samples is None:
            dt_samples = default_dt_samples()
        boundaries = fit_boundaries(np.asarray(dt_samples), cfg.n_entries)
    boundaries = torch.as_tensor(boundaries, dtype=torch.float32,
                                 device=device)
    if cosine_params is not None:
        lo = torch.cat([boundaries.new_zeros(1), boundaries])
        hi = torch.cat([boundaries, boundaries[-1:] * 2 + 1.0])
        table = cosine_encode(cosine_params, 0.5 * (lo + hi))
    else:
        table = torch.randn((cfg.n_entries, cfg.dim),
                            generator=generator).to(device)
    return {"boundaries": boundaries, "table": table}


def lut_bucket(boundaries: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """bucket(dt) = number of boundaries <= dt."""
    dt = dt.to(torch.float32)
    return (dt[..., None] >= boundaries).sum(dim=-1)


def lut_encode(params: dict, dt: torch.Tensor) -> torch.Tensor:
    """Phi(dt) via table lookup: (...,) -> (..., dim)."""
    return params["table"][lut_bucket(params["boundaries"], dt)]


def fold_projection(params: dict, w_time: torch.Tensor,
                    b_contrib: torch.Tensor | None = None) -> dict:
    """Precompute table @ W (the paper's 'LUT x weight matrices' fold).

    ``w_time`` is the slice of a downstream weight matrix that multiplies
    the time-encoding part of a concatenated input (dim, out); the returned
    params encode dt directly into the projected space.
    """
    table = params["table"] @ w_time
    if b_contrib is not None:
        table = table + b_contrib
    return {"boundaries": params["boundaries"], "table": table}
