"""End-to-end LM training on the PyTorch/CUDA port, as
``examples/lm_pretrain.py`` runs it on the JAX package: pretrain a
~100M-parameter dense transformer for a few hundred steps on synthetic
tokens, with fault-tolerant checkpointing — kill this script at any point
and rerun it: it resumes from the newest valid checkpoint with the bits an
uninterrupted run has (deterministic kernels and data order). Runs on the
GPU; ``--device cpu`` runs on the CPU. Later arguments override the
defaults below (e.g. ``--steps 20 --seq 64``); checkpoints go to
``--ckpt``, by default a directory under the temporary directory.

    PYTHONPATH=src python examples/lm_pretrain_torch.py [--steps 200]
    PYTHONPATH=src python examples/lm_pretrain_torch.py --device cpu \\
        --steps 4 --batch 1 --seq 32 --ckpt-every 2
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    main(["--mode", "lm", "--preset", "100m", "--steps", "200", "--batch",
          "4", "--seq", "256", "--ckpt",
          os.path.join(tempfile.gettempdir(), "repro_torch_lm100m"),
          "--ckpt-every", "50", "--log-every", "10"] + sys.argv[1:])
