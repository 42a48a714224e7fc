"""mamba2-130m: 24L d_model=768, attention-free SSD (state-space duality),
ssm_state=128, headdim=64, expand=2, vocab=50280. [arXiv:2405.21060;
unverified]

Runs long_500k: decode state is O(1) in history (the point of SSMs).
"""
from repro_torch.models.mamba2 import MambaConfig

ARCH_ID = "mamba2_130m"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> MambaConfig:
    return MambaConfig(
        arch=ARCH_ID, n_layers=24, d_model=768, expand=2, d_head=64,
        d_state=128, n_groups=1, conv_width=4, vocab=50_280, chunk=256)


def smoke_config() -> MambaConfig:
    return MambaConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, expand=2, d_head=16,
        d_state=32, n_groups=1, conv_width=4, vocab=512, chunk=16,
        dtype="float32", loss_chunk=32)
