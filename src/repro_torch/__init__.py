"""PyTorch/CUDA port of the TGN streaming-inference system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``data/``, ``kernels/``, ``serving/``, ``launch/``) and runs on
one Hopper GPU. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device it raises.

Everything is fp32, as in the reference: TF32 is switched off for matmuls and
cuDNN at import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
