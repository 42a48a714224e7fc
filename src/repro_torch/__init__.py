"""PyTorch/CUDA port of the TGN streaming-inference system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``data/``, ``kernels/``, ``serving/``, ``launch/``, and the
language models' ``models/`` and ``configs/``) and runs on one Hopper GPU.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device it raises.

The TGN path is fp32, as in the reference, and so is every fp32 product of
the language models: TF32 is switched off for matmuls and cuDNN at import.
A language model computes in its config's dtype (bf16 for the published
configs) on fp32 weights, as the reference does.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
