"""grok-1-314b: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2, attention-logit softcap 30. [hf:xai-org/grok-1;
unverified]

fsdp2d + int8 optimizer moments: at 314B params, fp32 Adam moments alone
(2.5TB) exceed the pod's HBM — 8-bit moments are load-bearing here, not an
optimization (DESIGN.md §4). 8 experts on a 16-way model axis -> TP inside
each expert (ff shards), not EP.
"""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "grok_1_314b"
SHARD_MODE = "fsdp2d"
GRAD_ACCUM = 4
MOMENT_DTYPE = "int8"


def config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=32768, vocab=131_072, rope_theta=10_000.0,
        n_experts=8, top_k=2, softcap=30.0)


def smoke_config() -> LMConfig:
    return LMConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, n_experts=4, top_k=2,
        softcap=30.0, dtype="float32", q_block=16, k_block=16, loss_chunk=32)
