"""Training entry point: the paper's workflow on a synthetic temporal-graph
stream.

Port of the ``--mode tgn`` path of ``repro.launch.train``: train the
TGN-attn teacher, then distill the SAT+LUT+NP students (Eq. 17), printing
AP on the test window for the teacher and every Table-II student
(``+SAT``, ``+LUT``, ``+NP(L)``, ``+NP(M)``, ``+NP(S)``). With ``--ckpt``
each trained model is saved (``repro_torch.distributed.checkpoint``, the
reference's on-disk format). Runs on the GPU unless ``--device cpu`` is
given. The reference's ``--mode lm`` (its language-model zoo) is not
ported; this CLI refuses it.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --mode tgn
    PYTHONPATH=src python -m repro_torch.launch.train --edges 600 \\
        --f-mem 8 --epochs 1 --device cpu --ckpt /tmp/tgn_ckpt
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import tgn
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.training import tgn_trainer as TT
from repro_torch.utils import resolve_device

#: the distilled students of Table II, each with its model axes
STUDENTS = (("+SAT", dict(attention="sat", encoder="cosine")),
            ("+LUT", dict(attention="sat", encoder="lut")),
            ("+NP(L)", dict(attention="sat", encoder="lut", prune_k=6)),
            ("+NP(M)", dict(attention="sat", encoder="lut", prune_k=4)),
            ("+NP(S)", dict(attention="sat", encoder="lut", prune_k=2)))


def run_tgn(args) -> dict:
    device = resolve_device(args.device)
    g = tgd.DATASETS[args.dataset](n_edges=args.edges)
    base = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges,
                f_edge=g.cfg.f_edge, f_feat=g.cfg.f_feat,
                f_mem=args.f_mem, f_time=args.f_mem, f_emb=args.f_mem,
                m_r=10)
    tcfg = TT.TGNTrainConfig(batch_size=args.batch, epochs=args.epochs)
    _, va, te = stream.chronological_split(g)
    warm = slice(0, va.stop)

    t_cfg = tgn.TGNConfig(**base)
    t0 = time.time()
    t_params, losses = TT.train_teacher(g, t_cfg, tcfg, device=device)
    ap_teacher = TT.evaluate_ap(t_params, t_cfg, g, te, warm_window=warm,
                                device=device)
    print(f"[teacher] AP={ap_teacher:.4f} loss {losses[0]:.3f}->"
          f"{losses[-1]:.3f} ({time.time()-t0:.0f}s)", flush=True)
    if args.ckpt:
        ckpt.save(args.ckpt + "/teacher", 0, t_params,
                  meta={"ap": ap_teacher})

    results = {"Baseline": ap_teacher}
    for name, kw in STUDENTS:
        s_cfg = tgn.TGNConfig(**base, **kw)
        t0 = time.time()
        s_params, _ = TT.distill_student(g, t_params, t_cfg, s_cfg, tcfg,
                                         device=device)
        ap = TT.evaluate_ap(s_params, s_cfg, g, te, warm_window=warm,
                            device=device)
        results[name] = ap
        print(f"[{name}] AP={ap:.4f} (diff {ap-ap_teacher:+.4f}) "
              f"({time.time()-t0:.0f}s)", flush=True)
        if args.ckpt:
            ckpt.save(args.ckpt + f"/student_{name}", 0, s_params,
                      meta={"ap": ap})
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("tgn", "lm"), default="tgn")
    ap.add_argument("--dataset", default="wikipedia",
                    choices=tuple(tgd.DATASETS))
    ap.add_argument("--edges", type=int, default=4000)
    ap.add_argument("--f-mem", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--ckpt", default=None,
                    help="directory to save the teacher and each student in")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        ap.error("--mode lm (language-model pretraining) is not ported to "
                 "repro_torch; run it with repro.launch.train")
    return run_tgn(args)


if __name__ == "__main__":
    main()
