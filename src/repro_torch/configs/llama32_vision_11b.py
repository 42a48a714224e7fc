"""llama-3.2-vision-11b: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers every 5th layer; vision frontend
STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.models.vision_lm import VisionLMConfig

ARCH_ID = "llama32_vision_11b"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> VisionLMConfig:
    return VisionLMConfig(
        arch=ARCH_ID, n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=14336, vocab=128_256, n_patches=1024,
        rope_theta=500_000.0, cross_every=5)


def smoke_config() -> VisionLMConfig:
    return VisionLMConfig(
        arch=ARCH_ID + "_smoke", n_layers=10, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, n_patches=16,
        cross_every=5, dtype="float32", q_block=16, k_block=16,
        loss_chunk=32)
