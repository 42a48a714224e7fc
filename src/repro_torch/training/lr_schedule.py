"""Learning-rate schedules as pure step -> scale functions (the scale
multiplies ``OptimConfig.lr``). Port of ``repro.training.lr_schedule``."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class ScheduleConfig(FrozenConfig):
    name: str = "warmup_cosine"   # warmup_cosine | warmup_linear | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1        # floor as a fraction of peak


def schedule(cfg: ScheduleConfig, step) -> torch.Tensor:
    """The lr scale at ``step`` (an int or a tensor), as an fp32 tensor."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.name == "constant":
        return warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.name == "warmup_linear":
        decay = 1.0 - (1.0 - cfg.min_ratio) * frac
    else:  # warmup_cosine
        decay = cfg.min_ratio + (1.0 - cfg.min_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    return warm * decay
