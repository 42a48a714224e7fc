"""gemma3-12b: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

5:1 local:global layer pattern (sliding window 1024 on locals), qk-norm,
RoPE theta 1M on globals (8x linear scaling) / 10k on locals, d_head 256.
[hf:google/gemma-3-1b-pt family; unverified]
"""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma3_12b"
SHARD_MODE = "tp"
GRAD_ACCUM = 1

_PATTERN = ("local",) * 5 + ("global",)


def config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID, n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        d_head=256, d_ff=15360, vocab=262_144,
        pattern=_PATTERN, window=1024,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, rope_scaling=8.0,
        qk_norm=True, embed_scale=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID + "_smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        pattern=_PATTERN, window=16,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, rope_scaling=8.0,
        qk_norm=True, embed_scale=True, dtype="float32",
        q_block=16, k_block=16, loss_chunk=32)
