"""Generate tokens with every registered architecture (reduced configs) on
the PyTorch/CUDA port, as ``examples/arch_zoo_decode.py`` does on the JAX
package: the uniform family adapter and its KV, ring, SSM and LRU caches.
Runs on the GPU; ``--device cpu`` runs the same on the CPU.

    PYTHONPATH=src python examples/arch_zoo_decode_torch.py
    PYTHONPATH=src python examples/arch_zoo_decode_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm_common
from repro_torch.serving import lm_serve
from repro_torch.utils import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

prompts = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (2, 6)),
                          dtype=torch.int32, device=device)
for arch in configs.all_archs():
    cfg = configs.get(arch).smoke_config()
    params = lm_common.init_params(torch.Generator(device=device).manual_seed(
        0), cfg, device)
    out = lm_serve.generate(params, cfg, prompts % cfg.vocab,
                            lm_serve.ServeConfig(max_new_tokens=8))
    print(f"{arch:22s} tokens={tuple(out['tokens'].shape)} "
          f"decode={out['decode_s_per_tok']*1e3:6.2f} ms/tok")
