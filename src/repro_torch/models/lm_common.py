"""Uniform adapter over the model families (transformer / mamba2 / rglru /
whisper / vision_lm), the port of ``repro.models.lm_common``: one
signature for losses, decode steps, abstract parameter trees and input
specs, so the trainer, the serve loop and tests never special-case a
family.

Batch layouts:
  train:   {"tokens": (B,S) int32, "targets": (B,S) int32
            [, "frames" | "vision"]}
  decode:  {"token": (B,1) int32, "caches": <family cache tree>}

The reference's abstract trees hold ``ShapeDtypeStruct``s; the port's
hold tensors on the ``meta`` device, which have a shape and a dtype and
no storage.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models import mamba2, rglru, transformer, vision_lm, whisper
from repro_torch.utils import resolve_device

META = torch.device("meta")

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


def abstract_params(cfg) -> dict:
    """The parameter tree's shapes and dtypes, as ``meta`` tensors (nothing
    is drawn or allocated)."""
    return init_params(torch.Generator(), cfg, META)


def loss_fn(params, cfg, batch: dict) -> torch.Tensor:
    fam = family_of(cfg)
    if fam == "whisper":
        return whisper.loss_fn(params, cfg, batch["frames"], batch["tokens"],
                               batch["targets"])
    if fam == "vision_lm":
        return vision_lm.loss_fn(params, cfg, batch["tokens"],
                                 batch["vision"], batch["targets"])
    return FAMILIES[fam].loss_fn(params, cfg, batch["tokens"],
                                 batch["targets"])


def decode_fn(params, cfg, batch: dict):
    """One serve step: next-token logits + the caches, updated in place."""
    return FAMILIES[family_of(cfg)].decode_step(params, cfg, batch["token"],
                                                batch["caches"])


def abstract_caches(cfg, batch: int, seq_len: int) -> dict:
    """The family's cache tree for ``batch`` rows of ``seq_len`` positions
    (the default bf16 caches), as ``meta`` tensors."""
    return FAMILIES[family_of(cfg)].init_caches(cfg, batch, seq_len,
                                                device=META)


def _materialize(specs: dict, device) -> dict:
    """Zeros of each ``meta`` leaf's shape and dtype on ``device``."""
    device = resolve_device(device)
    return tree.map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)


def train_inputs(cfg, batch: int, seq_len: int, *, abstract: bool = True,
                 device=None) -> dict:
    """A training batch's specs (``meta`` tensors), or with ``abstract``
    False zeros of them on ``device`` (``cuda`` unless the caller names
    another). Frames and vision tokens are bf16, as the reference's
    specs."""
    fam = family_of(cfg)
    specs = {
        "tokens": torch.empty((batch, seq_len), dtype=torch.int32,
                              device=META),
        "targets": torch.empty((batch, seq_len), dtype=torch.int32,
                               device=META),
    }
    if fam == "whisper":
        specs["frames"] = torch.empty((batch, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    if fam == "vision_lm":
        specs["vision"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    return specs if abstract else _materialize(specs, device)


def decode_inputs(cfg, batch: int, seq_len: int, *, abstract: bool = True,
                  device=None) -> dict:
    """A single-token decode step's specs against a ``seq_len``-long cache
    (``meta`` tensors), or with ``abstract`` False zeros of them on
    ``device``."""
    specs = {"token": torch.empty((batch, 1), dtype=torch.int32,
                                  device=META),
             "caches": abstract_caches(cfg, batch, seq_len)}
    return specs if abstract else _materialize(specs, device)


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
