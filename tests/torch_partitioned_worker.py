"""Run by ``tests/test_torch_partitioned.py``: the partitioned forms
(``repro_torch/distributed/partitioned.py``) on DTensors over a ``gloo``
group of 2 processes, against the plain functions on the whole tensors.

``python tests/torch_partitioned_worker.py PORT OUT`` spawns the two ranks
(one thread each), and prints ``RESULT {...}``: for each check, its worst
element against the tolerance it is held to, and how often each form was
entered. Every input is drawn from a seeded numpy generator, the same on
both ranks.

Meshes are (data, model) = (1, 2), the model axis splitting the sequence,
the cache slots, the vocab or the experts, and (2, 1), the data axis
splitting the tokens and the MoE capacity rows.
"""
import json
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the stated tolerances (atol = rtol): heads are independent in the SSD
#: scan; the softmax, the cross-entropy, the MoE combine and every
#: gradient of a shared operand (the SSD's a, b and c, summed over the
#: shards' heads) reorder their sums
TOL = {"ssd": 1e-6, "ssd_grad": 1e-5, "decode": 1e-5, "xent": 1e-5,
       "moe": 1e-5, "embed": 1e-5}


def _t(rng, *shape, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           * scale)


class Checks:
    def __init__(self):
        self.worst: dict = {}

    """Each check's worst element: ``|got - want| - tol * |want|``, to be
    at most ``tol`` (0 for a bitwise check that holds)."""

    def close(self, name, got, want, kind):
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        diff = (got.double() - want.double()).abs()
        tol = TOL[kind]
        excess = (diff - tol * want.double().abs()).max().item()
        self.worst[name] = (max(self.worst.get(name, (-math.inf,))[0],
                                excess), tol)
        assert excess <= tol, (name, diff.max().item())

    def same(self, name, got, want):
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        assert torch.equal(got, want), name
        self.worst[name] = (0.0, 0.0)


def _count_entries(entered: dict) -> None:
    """Count the calls of each form's entry point."""
    from repro_torch.distributed import partitioned
    for form, names in (("ssd", ["ssd_chunked"]),
                        ("decode", ["decode_softmax",
                                    "pruned_decode_softmax", "index_write"]),
                        ("xent", ["xent_sum"]), ("embed", ["embed"]),
                        ("moe", ["moe_ffn"])):
        entered[form] = 0
        for name in names:
            fn = getattr(partitioned, name)

            def counted(*a, _fn=fn, _form=form, **k):
                entered[_form] += 1
                return _fn(*a, **k)
            setattr(partitioned, name, counted)


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(2).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _dt(t, mesh, placements, grad=False):
    from torch.distributed.tensor import distribute_tensor
    d = distribute_tensor(t.detach().clone(), mesh, placements)
    return d.requires_grad_(grad)


def _grads_of(fn, leaves, seed):
    """fn(*leaves) and the gradients of <fn(...), w> for a seeded w."""
    out = fn(*leaves)
    full = out.full_tensor() if hasattr(out, "full_tensor") else out
    w = _t(np.random.default_rng(seed), *full.shape)
    (full * w).sum().backward()
    return full.detach(), [leaf.grad for leaf in leaves]


def check_ssd(c: Checks):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import mamba2
    mesh = _mesh((1, 2))
    for H, P in ((4, 4), (3, 4), (1, 6)):      # heads split; P split
        rng = np.random.default_rng(H)
        B, L, G, N, Q = 2, 16, 1, 5, 4
        x = _t(rng, B, L, H, P)
        dt = torch.nn.functional.softplus(_t(rng, B, L, H))
        a = -torch.exp(_t(rng, H, scale=0.5))
        b, cc = _t(rng, B, L, G, N), _t(rng, B, L, G, N)
        seq = [Replicate(), Shard(1)]
        leaves = [x, dt, a, b, cc]
        plain = [t.clone().requires_grad_() for t in leaves]
        want, want_g = _grads_of(
            lambda *t: mamba2.ssd_chunked(*t, Q)[0], plain, 7)
        # x whole on the model axis, dt split (the placements one torch
        # version's strategies give the site), for the 4 heads
        xpl = [Replicate()] * 2 if H == 4 else seq
        dist_leaves = [_dt(x, mesh, xpl, True), _dt(dt, mesh, seq, True),
                       _dt(a, mesh, [Replicate()] * 2, True),
                       _dt(b, mesh, seq, True), _dt(cc, mesh, seq, True)]
        got, got_g = _grads_of(
            lambda *t: mamba2.ssd_chunked(*t, Q)[0], dist_leaves, 7)
        assert type(dist_leaves[0]) is not torch.Tensor
        c.close(f"ssd y H={H} P={P}", got, want, "ssd")
        for name, g, w in zip("x dt a b c".split(), got_g, want_g):
            c.close(f"ssd grad {name} H={H}", g, w, "ssd_grad")
        # the final state, from a given initial one
        h0 = _t(rng, B, H, P, N)
        yw, hw = mamba2.ssd_chunked(x, dt, a, b, cc, Q, h0)
        yg, hg = mamba2.ssd_chunked(
            _dt(x, mesh, seq), _dt(dt, mesh, seq),
            _dt(a, mesh, [Replicate()] * 2), _dt(b, mesh, seq),
            _dt(cc, mesh, seq), Q, _dt(h0, mesh, [Replicate()] * 2))
        c.close(f"ssd y from h0 H={H}", yg, yw, "ssd")
        c.close(f"ssd h_final H={H}", hg, hw, "ssd")


def _attn_params(rng, cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {"wq": _t(rng, d, h * hd, scale=0.3),
            "wk": _t(rng, d, kv * hd, scale=0.3),
            "wv": _t(rng, d, kv * hd, scale=0.3),
            "wo": _t(rng, h * hd, d, scale=0.3)}


def check_decode(c: Checks):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers as L
    mesh = _mesh((1, 2))
    rep = [Replicate()] * 2
    slots = [Replicate(), Shard(1)]
    B, S = 3, 8
    for name, cfg, ring, keep in (
            ("full", L.AttnCfg(16, 4, 2, 4, softcap=5.0), False, 0),
            ("full bf16 cache", L.AttnCfg(16, 4, 2, 4, cache_upcast=False),
             False, 0),
            ("ring", L.AttnCfg(16, 4, 2, 4, window=4), True, 0),
            ("pruned", L.AttnCfg(16, 4, 2, 4), False, 3)):
        rng = np.random.default_rng(len(name))
        p = _attn_params(rng, cfg)
        n = 4 if ring else S
        cache = {"k": _t(rng, B, n, 2, 4), "v": _t(rng, B, n, 2, 4),
                 "pos": torch.tensor(2, dtype=torch.int32)}
        if ring:
            cache["k_pos"] = torch.tensor([0, 1, -1, -1], dtype=torch.int32)
        if not cfg.cache_upcast:
            cache["k"], cache["v"] = (cache["k"].bfloat16(),
                                      cache["v"].bfloat16())
        plain = {k: v.clone() for k, v in cache.items()}
        dcache = {k: _dt(v, mesh, slots if k in "kv" else rep)
                  for k, v in cache.items()}
        dp = {k: _dt(v, mesh, rep) for k, v in p.items()}
        for step in range(5):                 # across the ring's wrap
            x = _t(rng, B, 1, 16)
            with torch.no_grad():
                if keep:
                    want, _ = L.pruned_decode_attention(p, cfg, x, plain,
                                                        keep)
                else:
                    want, _ = L.decode_attention(p, cfg, x, plain)
                with implicit_replication():
                    dx = _dt(x, mesh, rep)
                    if keep:
                        got, _ = L.pruned_decode_attention(dp, cfg, dx,
                                                           dcache, keep)
                    else:
                        got, _ = L.decode_attention(dp, cfg, dx, dcache)
            assert dcache["k"].placements == tuple(slots)
            c.close(f"decode {name} out", got, want, "decode")
            for k in plain:
                c.same(f"decode {name} cache {k}", dcache[k], plain[k])


def check_xent(c: Checks):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers as L
    mesh = _mesh((1, 2))
    rng = np.random.default_rng(11)
    B, S, D, V = 2, 8, 6, 10
    h, w = _t(rng, B, S, D), _t(rng, D, V)
    tg = torch.as_tensor(rng.integers(0, V, (B, S)), dtype=torch.int32)
    hp, wp = h.clone().requires_grad_(), w.clone().requires_grad_()
    want = L.chunked_xent(hp, wp, tg, 4)
    want.backward()
    hd = _dt(h, mesh, [Replicate()] * 2, True)
    wd = _dt(w, mesh, [Replicate(), Shard(1)], True)
    with implicit_replication():
        got = L.chunked_xent(hd, wd, _dt(tg, mesh, [Replicate()] * 2), 4)
        got.full_tensor().backward()
    c.close("xent loss", got, want, "xent")
    c.close("xent grad h", hd.grad, hp.grad, "xent")
    c.close("xent grad w", wd.grad, wp.grad, "xent")


def check_embed(c: Checks):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import layers as L
    mesh = _mesh((1, 2))
    rng = np.random.default_rng(13)
    table = _t(rng, 10, 6)
    # more token rows than a shard's table rows (the table's all-to-all),
    # and fewer (the rows' reduce-scatter)
    for shape in ((3, 5), (2, 1)):
        tok = torch.as_tensor(rng.integers(0, 10, shape), dtype=torch.int32)
        tp = table.clone().requires_grad_()
        want, (gw,) = _grads_of(lambda t: L.embed({"embed": t}, tok,
                                                  torch.float32), [tp], 3)
        td = _dt(table, mesh, [Replicate(), Shard(0)], True)
        got, (gg,) = _grads_of(
            lambda t: L.embed({"embed": t},
                              _dt(tok, mesh, [Replicate()] * 2),
                              torch.float32), [td], 3)
        c.close(f"embed rows {shape}", got, want, "embed")
        c.close(f"embed grad {shape}", gg, gw, "embed")


def check_moe(c: Checks):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import moe as M
    # (mesh, experts, what splits them, capacity factor): the EP and TP
    # forms over model, and the capacity rows over data; a small capacity
    # factor drops assignments
    cases = (((1, 2), 4, "ep", 1.25), ((1, 2), 3, "tp", 1.25),
             ((1, 2), 4, "ep", 0.3), ((2, 1), 4, "ep", 0.3),
             ((2, 1), 4, "ep", 1.25))
    for shape, E, how, cf in cases:
        mesh = _mesh(shape)
        rng = np.random.default_rng(E)
        T, D, F, k = 320, 6, 4, 2
        p = {"router": _t(rng, D, E), "w_gate": _t(rng, E, D, F, scale=.4),
             "w_up": _t(rng, E, D, F, scale=.4),
             "w_down": _t(rng, E, F, D, scale=.4)}
        x = _t(rng, T, D)
        names = ["x", "router", "w_gate", "w_up", "w_down"]
        plain = [x.clone().requires_grad_()] + [
            p[n].clone().requires_grad_() for n in names[1:]]

        def run(x, router, w_gate, w_up, w_down):
            return M.moe_ffn({"router": router, "w_gate": w_gate,
                              "w_up": w_up, "w_down": w_down}, x, k,
                             capacity_factor=cf)
        want, want_g = _grads_of(run, plain, 5)
        tok = [Shard(0), Replicate()]
        e_in = [Replicate(), Shard(0) if how == "ep" else Shard(2)]
        e_out = [Replicate(), Shard(0) if how == "ep" else Shard(1)]
        leaves = [_dt(x, mesh, tok, True),
                  _dt(p["router"], mesh, [Replicate()] * 2, True),
                  _dt(p["w_gate"], mesh, e_in, True),
                  _dt(p["w_up"], mesh, e_in, True),
                  _dt(p["w_down"], mesh, e_out, True)]
        from repro_torch.distributed import partitioned
        assert partitioned.moe_splits(
            {"w_gate": leaves[2]}, leaves[0]), (shape, how)
        got, got_g = _grads_of(run, leaves, 5)
        tag = f"moe {how} {shape} cf={cf}"
        c.close(f"{tag} y", got, want, "moe")
        for n, g, w in zip(names, got_g, want_g):
            c.close(f"{tag} grad {n}", g, w, "moe")


def worker(rank: int, port: int, out_path: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    c = Checks()
    entered: dict = {}
    _count_entries(entered)
    try:
        for check in (check_ssd, check_decode, check_xent, check_embed,
                      check_moe):
            check(c)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"worst": c.worst, "entered": entered}, f)


def main():
    port, out_path = int(sys.argv[1]), sys.argv[2]
    mp.spawn(worker, args=(port, out_path), nprocs=2, join=True)
    with open(out_path) as f:
        print("RESULT " + f.read())


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
