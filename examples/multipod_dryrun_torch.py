"""Multi-pod dry-run example, on the PyTorch port: trace one (arch x shape)
cell on the production 2-pod x 256-device mesh (DTensors over a fake
process group of 512 ranks, ``meta`` locals) and print the roofline
decomposition.

    PYTHONPATH=src python examples/multipod_dryrun_torch.py [--device cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.dryrun import destroy_world, run_cell  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="the mesh's device type: cuda (default) or cpu")
args = ap.parse_args()
try:
    result = run_cell("gemma3_12b", "decode_32k", multi_pod=True,
                      device=args.device)
finally:
    destroy_world()
print(json.dumps({k: v for k, v in result.items()
                  if k not in ("per_device",)}, indent=2))
print("collectives:", result["per_device"]["collectives_by_op"])
