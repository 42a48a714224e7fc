"""Architecture registry: ``--arch <id>`` resolves here. The port's own copy
of ``repro.configs``: the same ids, fields and values, so a config of
either package equals the other's field by field.

Each config module exposes:
    ARCH_ID      str
    SHARD_MODE   "tp" | "fsdp2d"   (multi-card layouts; one card uses neither)
    config()     full assigned-size config
    smoke_config()  reduced same-family config for CPU smoke tests
Optional:
    MOMENT_DTYPE    optimizer moment storage ("float32"|"bfloat16"|"int8")
    GRAD_ACCUM      micro-batches per train step at the assigned shapes
"""
from __future__ import annotations

import dataclasses
import importlib

_ARCH_IDS = (
    "gemma3_12b", "mistral_nemo_12b", "granite_3_8b", "qwen3_8b",
    "dbrx_132b", "grok_1_314b", "mamba2_130m", "whisper_tiny",
    "recurrentgemma_9b", "llama32_vision_11b",
)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    module: object

    @property
    def shard_mode(self) -> str:
        return self.module.SHARD_MODE

    @property
    def moment_dtype(self) -> str:
        return getattr(self.module, "MOMENT_DTYPE", "float32")

    @property
    def grad_accum(self) -> int:
        return getattr(self.module, "GRAD_ACCUM", 1)

    def config(self):
        return self.module.config()

    def smoke_config(self):
        return self.module.smoke_config()


def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "")


def get(arch_id: str) -> ArchSpec:
    name = _norm(arch_id)
    if name not in _ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return ArchSpec(arch_id=name, module=mod)


def all_archs() -> list[str]:
    return list(_ARCH_IDS)


# Shape cells (assignment): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}
