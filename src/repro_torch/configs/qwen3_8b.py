"""qwen3-8b: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk-norm. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen3_8b"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID, n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=12288, vocab=151_936, rope_theta=1_000_000.0,
        qk_norm=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, qk_norm=True,
        dtype="float32", q_block=16, k_block=16, loss_chunk=32)
