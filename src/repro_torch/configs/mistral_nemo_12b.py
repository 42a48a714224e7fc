"""mistral-nemo-12b: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128, 128k ctx (RoPE theta 1M), full attention.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "mistral_nemo_12b"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID, n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=14336, vocab=131_072, rope_theta=1_000_000.0)


def smoke_config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        rope_theta=1_000_000.0, dtype="float32",
        q_block=16, k_block=16, loss_chunk=32)
