"""The language-model families of the port (training and serving): transformer
(dense and MoE), mamba2, rglru, whisper and vision_lm, with the shared
layers and MoE blocks."""
