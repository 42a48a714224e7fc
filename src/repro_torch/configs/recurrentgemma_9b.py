"""recurrentgemma-9b: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention (window 2048), 1 attn : 2 recurrent.
[arXiv:2402.19427; unverified]

Runs long_500k: recurrent state + ring window caches are O(1) in history.
"""
from repro_torch.models.rglru import GriffinConfig

ARCH_ID = "recurrentgemma_9b"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> GriffinConfig:
    return GriffinConfig(
        arch=ARCH_ID, n_layers=38, d_model=4096, lru_width=4096, n_heads=16,
        n_kv_heads=1, d_head=256, d_ff=12288, vocab=256_000, window=2048)


def smoke_config() -> GriffinConfig:
    return GriffinConfig(
        arch=ARCH_ID + "_smoke", n_layers=8, d_model=64, lru_width=64,
        n_heads=4, n_kv_heads=1, d_head=16, d_ff=128, vocab=512, window=16,
        dtype="float32", q_block=16, k_block=16, loss_chunk=32)
