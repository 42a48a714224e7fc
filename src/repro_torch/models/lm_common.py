"""Uniform adapter over the model families (transformer / mamba2 / rglru /
whisper / vision_lm), the port of ``repro.models.lm_common`` (serving
half): one signature for parameter init and decode steps, so the serve
loop and tests never special-case a family.

Decode batch layout: {"token": (B,1) int32, "caches": <family cache tree>}.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba2, rglru, transformer, vision_lm, whisper

FAMILIES = {
    "transformer": transformer,
    "mamba2": mamba2,
    "rglru": rglru,
    "whisper": whisper,
    "vision_lm": vision_lm,
}


def family_of(cfg) -> str:
    if isinstance(cfg, transformer.LMConfig):
        return "transformer"
    if isinstance(cfg, mamba2.MambaConfig):
        return "mamba2"
    if isinstance(cfg, rglru.GriffinConfig):
        return "rglru"
    if isinstance(cfg, whisper.WhisperConfig):
        return "whisper"
    if isinstance(cfg, vision_lm.VisionLMConfig):
        return "vision_lm"
    raise TypeError(type(cfg))


def init_params(generator: torch.Generator, cfg, device):
    """The family's parameter tree, drawn from ``generator`` (on its
    device) and placed on ``device``."""
    return FAMILIES[family_of(cfg)].init(generator, cfg, device)


def decode_fn(params, cfg, batch: dict):
    """One serve step: next-token logits + the caches, updated in place."""
    return FAMILIES[family_of(cfg)].decode_step(params, cfg, batch["token"],
                                                batch["caches"])


def supports_long_context(cfg) -> bool:
    """True when decode memory/compute per token is sub-linear in history
    (SSM/hybrid) or dominated by windowed layers (gemma3-style local:global).
    Pure full-attention archs skip ``long_500k``."""
    fam = family_of(cfg)
    if fam in ("mamba2", "rglru"):
        return True
    if fam == "transformer":
        return cfg.window is not None and "local" in cfg.pattern
    return False


def has_decode(cfg) -> bool:
    return True  # all registered archs are decoder-bearing (whisper: enc-dec)
