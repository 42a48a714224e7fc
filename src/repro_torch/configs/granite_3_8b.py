"""granite-3-8b: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base family; hf]
"""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "granite_3_8b"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID, n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=12800, vocab=49_155, rope_theta=10_000.0)


def smoke_config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, dtype="float32",
        q_block=16, k_block=16, loss_chunk=32)
