"""The frozen stream generator and the fleet's replay of it."""
import numpy as np

from tgnbench import traffic, weights
from tgnbench.small import load_cell


def test_frozen_generator_is_the_programs():
    from repro_torch.data import temporal_graph as tgd

    want = tgd.generate(tgd.StreamConfig(n_users=50, n_items=20,
                                         n_edges=700, f_edge=12, seed=5))
    got = traffic.generate(50, 20, 700, 12, seed=5)
    for a, b in ((got.src, want.src), (got.dst, want.dst), (got.ts, want.ts),
                 (got.edge_feats, want.edge_feats)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_replay_is_chronological_with_full_batches():
    g = traffic.generate(30, 10, 1000, 4, seed=traffic.seed32(2 ** 31 + 7, 0))
    T, B = 5, 64
    feed = traffic.Replay(g, T, B, shift=977)
    rounds = 3 * 1000 // B          # every tenant wraps at least twice
    parts = [feed.batch(r) for r in range(rounds)]
    src, dst, eid, ts = (np.concatenate(x, axis=1) for x in zip(*parts))
    assert src.shape == (T, rounds * B)
    assert np.all(np.diff(ts.astype(np.float64), axis=1) >= 0)
    assert np.all((eid >= 0) & (eid < 1000))
    assert np.array_equal(src, g.src[eid]) and np.array_equal(dst, g.dst[eid])
    # tenant i starts at edge shift + i * floor(E / T) and wraps past the end
    assert np.array_equal(eid[:, 0], (977 + np.arange(T) * (1000 // T)) % 1000)
    assert np.all((eid[:, 1:] == 0) .sum(axis=1) >= 2)
    # one tenant of a sample sees the same batches as in the whole fleet
    s, d, e, t = feed.batch(7, [3])
    assert np.array_equal(t[0], parts[7][3][3])


def test_weights_fit_the_programs_layout():
    from repro_torch.serving.session import _cfg_param_signature, _tree_signature
    from repro_torch.core import pipeline as pl

    for cell in ("student-fleet64-b600", "teacher-fleet64-b600"):
        cfg = {**load_cell(cell)["config"], "n_users": 40,
               "n_items": 10}
        model = pl.variant_config(
            cfg["variant"], n_nodes=50, n_edges=100, f_edge=cfg["f_edge"],
            f_mem=cfg["f_mem"], f_time=cfg["f_time"], f_emb=cfg["f_emb"],
            m_r=cfg["m_r"], n_heads=cfg["n_heads"],
            lut_entries=cfg["lut_entries"])
        p = weights.init(cfg, 123, "cpu")
        assert _tree_signature(p) == _cfg_param_signature(model)
        q = weights.init(cfg, 123, "cpu")
        assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(
            _leaves(p), _leaves(q)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
