"""Quickstart on the PyTorch/CUDA port: the paper's co-design end to end, as
``examples/quickstart.py`` runs it on the JAX package.

Builds a synthetic temporal graph, trains the TGN-attn teacher for one
epoch, distills the SAT+LUT+NP(4) student (Eq. 17), evaluates both by AP,
and streams inference of the student through the engine's staged kernel
tier (LUT time encoder, prune-then-fetch, the GRU and SAT kernels). Runs
on the GPU; ``--device cpu`` runs the same on the CPU, where the kernels'
plain versions stand in for them.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core.pipeline import variant_config
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.training import tgn_trainer as TT
from repro_torch.utils import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

# 1. data: Wikipedia-like bipartite interaction stream
g = tgd.wikipedia_like(n_edges=3000)
base = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
            f_mem=32, f_time=32, f_emb=32, m_r=10)

# 2. teacher: vanilla temporal attention + cosine time encoder
teacher_cfg = variant_config("teacher", **base)
tcfg = TT.TGNTrainConfig(batch_size=100, epochs=1)
teacher, _ = TT.train_teacher(g, teacher_cfg, tcfg, device=device)
tr, va, te = stream.chronological_split(g)
ap_t = TT.evaluate_ap(teacher, teacher_cfg, g, va, warm_window=tr,
                      device=device)
print(f"teacher AP: {ap_t:.4f}")

# 3. student: SAT + LUT + neighbor pruning (k=4), distilled (Eq. 17)
student_cfg = variant_config("sat+lut+np4", **base)
student, _ = TT.distill_student(g, teacher, teacher_cfg, student_cfg, tcfg,
                                device=device)
ap_s = TT.evaluate_ap(student, student_cfg, g, va, warm_window=tr,
                      device=device)
print(f"student AP: {ap_s:.4f} (diff {ap_s - ap_t:+.4f})")

# 4. optimized streaming inference (the paper's accelerator dataflow);
#    the SAME engine serves the teacher: EngineConfig(model=teacher_cfg)
engine = StreamingEngine(EngineConfig(model=student_cfg), student,
                         g.edge_feats, device=device)
print("engine stages:", engine.describe())
for _batch, _embs in engine.run(stream.fixed_count(g, 200)):
    pass
print("engine:", engine.summary())
