"""dbrx-132b: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]

fsdp2d sharding: 132B fp32 params cannot be DP-replicated. Experts shard
over the model axis (16 experts / 16-way = pure expert parallelism).
"""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "dbrx_132b"
SHARD_MODE = "fsdp2d"
GRAD_ACCUM = 2
MOMENT_DTYPE = "float32"


def config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID, n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=10752, vocab=100_352, rope_theta=500_000.0,
        n_experts=16, top_k=4)


def smoke_config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=96, vocab=512, n_experts=4, top_k=2,
        dtype="float32", q_block=16, k_block=16, loss_chunk=32)
