"""whisper-tiny: 4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865,
enc-dec with conv frontend STUB (input_specs provides precomputed frame
embeddings). [arXiv:2212.04356; unverified]
"""
from repro_torch.models.whisper import WhisperConfig

ARCH_ID = "whisper_tiny"
SHARD_MODE = "tp"
GRAD_ACCUM = 1


def config() -> WhisperConfig:
    return WhisperConfig(
        arch=ARCH_ID, n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_head=64, d_ff=1536, vocab=51_865, n_frames=1500, max_target=448)


def smoke_config() -> WhisperConfig:
    return WhisperConfig(
        arch=ARCH_ID + "_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=512, n_frames=32,
        max_target=64, dtype="float32", q_block=16, k_block=16,
        loss_chunk=32)
