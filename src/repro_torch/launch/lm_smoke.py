"""Smoke run of the port's language-model serving path on one device.

    PYTHONPATH=src python -m repro_torch.launch.lm_smoke

``run`` (chip_smoke's LM phase) checks, each with its stated tolerance:

a) every registered architecture at its ``smoke_config()`` on ``dev``
   against the same weights on the CPU (drawn once on the CPU from a seeded
   generator, then copied): ``prefill``'s last-token logits; then
   ``decode_step`` over the prompt and the CPU's 16 greedy tokens
   (teacher-forced on ``dev``) with the logits of every step, the
   greedy tokens wherever the CPU's top-2 gap is clear of the tolerance,
   and the final caches (fp32 caches; integer leaves — ``pos``, ring
   ``k_pos`` — equal); the MoE archs' ``route`` and ``build_dispatch``
   tables equal; gemma3's ring caches wrap (window 16 < 24 positions); one
   transformer also with ``kv_prune_keep``;
b) qwen3-8b at ``config()`` (full width and depth, weights drawn on
   ``dev``): the decode path's logits at each prompt position against
   ``unembed(backbone(...))`` in fp32 and in the config's bf16; greedy
   ``lm_serve.generate`` (B = 4, 8 + 16 tokens), its tokens replayed
   teacher-forced with every logit finite and each greedy token the
   replay's argmax; ms a token beside the roofline bound; a 2,048-token
   prefill through ``chunked_attention`` (4 x 2 blocks) against the same
   prefill in one block each way, logits and hidden states;
c) mamba2-130m and whisper-tiny at ``config()``: decode against prefill in
   fp32, and ms a token.

Each of b)'s three comparisons is run a second time with a fault planted
(``PLANTS``), and fails unless its limit rejects the fault. The full
configs are for the card (qwen3-8b holds 32.8 GB of fp32 parameters);
the CPU tests drive b) and c)'s functions at the smoke widths.
Every line it prints names the device (the card's name and power limit).
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import torch

from repro_torch import configs, tree
from repro_torch.core import perf_model
from repro_torch.launch import main_path as mp
from repro_torch.models import layers as L
from repro_torch.models import lm_common, mamba2, moe as M, transformer
from repro_torch.models import whisper
from repro_torch.serving import lm_serve
from repro_torch.utils import resolve_device

#: fp32 on the card against fp32 on the CPU at the smoke configs: sums in
#: other orders (cuBLAS against the CPU's BLAS), chained over 24 decode
#: steps through 2-10 layers
TOL_SMOKE = dict(rtol=1e-4, atol=1e-4)
#: fp32 decode against fp32 prefill at full width: other products (a row
#: at a time against 8 rows), the decode softmax against the online one,
#: compounded over up to 36 layers of 4,096-wide sums
TOL_FULL_F32 = dict(rtol=1e-4, atol=1e-4)
#: bf16 decode against bf16 prefill, and the chunked prefill against one
#: block, at full width: a 1-ulp difference before a bf16 rounding (2^-8 =
#: 0.39% relative) moves the rounded value, and such moves compound over
#: 36 layers; logits and hidden states are ~N(0, 1). The limit lies
#: between the sound comparisons' largest reading and that of the planted
#: "no rescale" (PERF.md, PR 22's findings)
TOL_FULL_BF16 = dict(rtol=0.0, atol=0.25)


#: faults planted into a second run of a full-width comparison, each
#: ``(module, function, wrap)``; the run fails unless the comparison's
#: limit rejects the fault. qwen3-8b's serving: the decode's attention
#: scores rounded to bf16 (they are fp32 in the reference), and the
#: chunked attention's online softmax without the rescale of its running
#: sums to a new max (the running max is raised before the step, so the
#: step's ``alpha`` is 1), which ``launch/lm_train_smoke.py`` also plants
#: into qwen3-8b's gradients; mamba2-130m's training: the reference's
#: intra-chunk decay, ``exp`` of every pair's exponent masked afterwards,
#: which overflows above the diagonal at chunk 256 and makes the
#: backward's gradients NaN
PLANTS = {
    "bf16 scores": (L, "_softcap",
                    lambda f: lambda s, cap: f(s, cap).bfloat16().float()),
    "no rescale": (L, "_online_softmax_step",
                   lambda f: lambda m, l, acc, s, v: f(
                       torch.maximum(m, torch.amax(s, dim=-1)), l, acc, s,
                       v)),
    "unmasked exponent": (
        mamba2, "_intra_decay",
        lambda f: lambda lt, causal: torch.where(
            causal, torch.exp(lt[:, :, :, None] - lt[:, :, None, :]), 0.0)),
}


@contextlib.contextmanager
def planted(fault: str):
    """``PLANTS[fault]`` in place of its function."""
    mod, name, wrap = PLANTS[fault]
    sound = getattr(mod, name)
    setattr(mod, name, wrap(sound))
    try:
        yield
    finally:
        setattr(mod, name, sound)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double().cpu() - want.double().cpu()).abs().max())


def close(got: torch.Tensor, want: torch.Tensor, tol: dict) -> bool:
    return torch.allclose(got.double().cpu(), want.double().cpu(), **tol)


def argmax_agrees(logits: torch.Tensor, want_logits: torch.Tensor,
                  tol: dict) -> tuple[bool, int, int]:
    """Whether ``logits``' argmax equals ``want_logits``' wherever the
    latter's top-2 gap exceeds twice the absolute tolerance (where every
    logit moves by at most that, a smaller gap may flip); how many
    positions that held; and at how many of all the argmax is equal."""
    want = want_logits.double().cpu()
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol["atol"]
    same = logits.double().cpu().argmax(-1) == want.argmax(-1)
    return bool(same[clear].all()), int(clear.sum()), int(same.sum())


def to_device(t, dev):
    return tree.map(lambda x: x.to(dev), t)


# ---------------------------------------------------------------------------
# a) the smoke configs, dev against the CPU
# ---------------------------------------------------------------------------


def _family_inputs(cfg, fam: str, params, prompts, dev, total: int,
                   extra):
    """(prefill logits, fp32 caches) of one device; ``extra`` is the
    whisper frames or the vision tokens (CPU), None otherwise."""
    mod = lm_common.FAMILIES[fam]
    toks = prompts.to(dev)
    B = toks.shape[0]
    if fam == "whisper":
        frames = extra.to(dev)
        logits, enc = mod.prefill(params, cfg, frames, toks)
        caches = mod.init_caches(cfg, B, total, params=params,
                                 enc_out=whisper.encode(params, cfg, frames),
                                 dtype=torch.float32)
        return logits, caches, enc
    if fam == "vision_lm":
        vision = extra.to(dev)
        logits, _ = mod.prefill(params, cfg, toks, vision)
        caches = mod.init_caches(cfg, B, total, params=params, vision=vision,
                                 dtype=torch.float32)
        return logits, caches, None
    logits, _ = mod.prefill(params, cfg, toks)
    caches = mod.init_caches(cfg, B, total, dtype=torch.float32, device=dev)
    return logits, caches, None


def decode_run(cfg, params, prompts, caches, new: int, forced=None):
    """The prompt teacher-forced through ``decode_step``, then ``new``
    tokens: greedy from its own logits, or ``forced`` (B, new). Returns
    (logits of every step (B, S+new, V), the new tokens (B, new),
    caches)."""
    mod = lm_common.FAMILIES[lm_common.family_of(cfg)]
    dev = tree.leaves(caches)[0].device
    toks = prompts.to(dev)
    steps, gen = [], []
    logits = None
    for t in range(toks.shape[1]):
        logits, caches = mod.decode_step(params, cfg, toks[:, t:t + 1],
                                         caches)
        steps.append(logits)
    for i in range(new):
        tok = (torch.argmax(logits, -1).to(torch.int32)[:, None]
               if forced is None else forced[:, i:i + 1].to(dev))
        gen.append(tok)
        logits, caches = mod.decode_step(params, cfg, tok, caches)
        steps.append(logits)
    gen = torch.cat(gen, 1) if gen else toks[:, :0]
    return torch.stack(steps, 1), gen, caches


def _moe_tables(cfg, params, prompts, dev):
    """``route`` + ``build_dispatch`` of block 0's first MoE layer over the
    embedded prompt (its ``ln2`` input at layer 0)."""
    lp = L.block_view(params["blocks"], 0)["l0"]
    x = L.embed(params["embed"], prompts.to(dev), cfg.compute_dtype)
    h = L.rmsnorm(lp["ln2"], x).reshape(-1, cfg.d_model)
    idx, probs = M.route(lp["moe"]["router"], h, cfg.top_k)
    E = cfg.n_experts
    return (idx, probs) + M.build_dispatch(
        idx, E, M.capacity(h.shape[0], E, cfg.top_k, cfg.capacity_factor))


def smoke_arch(arch: str, cfg, dev: torch.device, card: str) -> dict:
    """One smoke config on ``dev`` against the CPU; returns its errors."""
    fam = lm_common.family_of(cfg)
    B, Sp, new = mp.LM_SMOKE_B, mp.LM_PROMPT, mp.LM_NEW
    total = Sp + new
    cpu = torch.device("cpu")
    p_cpu = lm_common.init_params(torch.Generator().manual_seed(mp.LM_SEED),
                                  cfg, cpu)
    p_dev = to_device(p_cpu, dev)
    prompts = mp.lm_prompts(cfg.vocab, B)
    extra = None
    if fam in ("whisper", "vision_lm"):
        n = cfg.n_frames if fam == "whisper" else cfg.n_patches
        extra = torch.randn((B, n, cfg.d_model),
                            generator=torch.Generator().manual_seed(1))
    want_pf, c_cpu, enc_cpu = _family_inputs(cfg, fam, p_cpu, prompts, cpu,
                                             total, extra)
    got_pf, c_dev, enc_dev = _family_inputs(cfg, fam, p_dev, prompts, dev,
                                            total, extra)
    want, toks, c_cpu = decode_run(cfg, p_cpu, prompts, c_cpu, new)
    got, _, c_dev = decode_run(cfg, p_dev, prompts, c_dev, new, forced=toks)
    errs = {"prefill": max_err(got_pf, want_pf),
            "decode": max_err(got, want)}
    check(close(got_pf, want_pf, TOL_SMOKE), f"{arch}: prefill logits")
    check(close(got, want, TOL_SMOKE), f"{arch}: decode logits")
    if enc_cpu is not None:
        errs["encode"] = max_err(enc_dev, enc_cpu)
        check(close(enc_dev, enc_cpu, TOL_SMOKE), f"{arch}: encode")
    ok, held, _ = argmax_agrees(got[:, Sp - 1:-1], want[:, Sp - 1:-1],
                                TOL_SMOKE)
    check(ok, f"{arch}: greedy tokens")
    errs["cache"] = 0.0
    for (path, a), b in zip(tree.flatten_with_path(c_dev),
                            tree.leaves(c_cpu)):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{arch}: cache {path} dtype and shape")
        if a.dtype.is_floating_point:
            errs["cache"] = max(errs["cache"], max_err(a, b))
            check(close(a, b, TOL_SMOKE), f"{arch}: cache {path}")
        else:
            check(torch.equal(a.cpu(), b), f"{arch}: cache {path} equal")
    if fam == "transformer" and "local" in cfg.pattern:
        ring = c_cpu["l0"]
        check("k_pos" in ring and ring["k"].shape[2] < total
              and int(ring["k_pos"].max()) == total - 1,
              f"{arch}: the ring caches wrapped")
    if fam == "transformer" and cfg.n_experts:
        for a, b in zip(_moe_tables(cfg, p_dev, prompts, dev),
                        _moe_tables(cfg, p_cpu, prompts, cpu)):
            if a.dtype.is_floating_point:
                check(close(a, b, TOL_SMOKE), f"{arch}: route probs")
            else:
                check(torch.equal(a.cpu(), b),
                      f"{arch}: route / dispatch / keep / rank equal")
    print(f"lm smoke {arch}: prefill {errs['prefill']:.3g}, decode "
          f"{errs['decode']:.3g} over {Sp + new} steps, caches "
          f"{errs['cache']:.3g}"
          + (f", encode {errs['encode']:.3g}" if "encode" in errs else "")
          + f" max abs diff; greedy tokens equal at {held} of "
          f"{B * new} steps (the rest within the tolerance's gap); "
          f"{dev} vs cpu, tol {TOL_SMOKE}, on {card}", flush=True)
    return errs


def smoke_prune(arch: str, dev: torch.device, card: str) -> float:
    """``arch``'s smoke config with positional KV pruning (keep 8 of 24
    slots), ``dev`` against the CPU."""
    cfg = configs.get(arch).smoke_config().replace(
        kv_prune_keep=mp.LM_PRUNE_KEEP)
    B, Sp, new = mp.LM_SMOKE_B, mp.LM_PROMPT, mp.LM_NEW
    p_cpu = lm_common.init_params(torch.Generator().manual_seed(mp.LM_SEED),
                                  cfg, "cpu")
    prompts = mp.lm_prompts(cfg.vocab, B)
    want, toks, c_cpu = decode_run(
        cfg, p_cpu, prompts, transformer.init_caches(
            cfg, B, Sp + new, torch.float32, device="cpu"), new)
    got, _, c_dev = decode_run(
        cfg, to_device(p_cpu, dev), prompts, transformer.init_caches(
            cfg, B, Sp + new, torch.float32, device=dev), new, forced=toks)
    err = max_err(got, want)
    check(close(got, want, TOL_SMOKE), f"{arch} pruned: decode logits")
    for a, b in zip(tree.leaves(c_dev), tree.leaves(c_cpu)):
        check(close(a, b, TOL_SMOKE), f"{arch} pruned: caches")
    print(f"lm smoke {arch} kv_prune_keep={mp.LM_PRUNE_KEEP}: decode "
          f"{err:.3g} max abs diff over {Sp + new} steps; {dev} vs cpu, "
          f"tol {TOL_SMOKE}, on {card}", flush=True)
    return err


# ---------------------------------------------------------------------------
# b), c) full width: decode against prefill on one device
# ---------------------------------------------------------------------------


def prefill_logits(cfg, params, prompts, extra=None) -> torch.Tensor:
    """Logits at every prompt position (B, S, V) from the family's
    sequence forward."""
    fam = lm_common.family_of(cfg)
    if fam == "whisper":
        enc = whisper.encode(params, cfg, extra)
        return whisper._logits(params,
                               whisper.decode_train(params, cfg, prompts,
                                                    enc))
    mod = lm_common.FAMILIES[fam]
    return L.unembed(params["head"], mod.backbone(params, cfg, prompts))


def decode_vs_prefill(name: str, cfg, params, prompts, dev, card, tol,
                      extra=None, plant: str | None = None) -> dict:
    """The decode path's logits at each prompt position against the
    sequence forward's, on ``dev``, and ms a decode token; with ``plant``,
    also whether the limit rejects the decode run again with that fault."""
    fam = lm_common.family_of(cfg)
    mod = lm_common.FAMILIES[fam]
    B, S = prompts.shape
    want = prefill_logits(cfg, params, prompts, extra)

    def fresh():
        if fam == "whisper":
            return mod.init_caches(cfg, B, S, params=params,
                                   enc_out=whisper.encode(params, cfg, extra),
                                   dtype=torch.float32)
        return mod.init_caches(cfg, B, S, dtype=torch.float32, device=dev)

    got, _, _ = decode_run(cfg, params, prompts, fresh(), 0)
    caches = fresh()       # time a second pass, warm
    sync(dev)
    t0 = time.perf_counter()
    decode_run(cfg, params, prompts, caches, 0)
    sync(dev)
    ms_tok = (time.perf_counter() - t0) * 1e3 / S
    err = max_err(got, want)
    ok_tok, held, equal = argmax_agrees(got, want, tol)
    bad_err = rejected = None
    if plant is not None:
        with planted(plant):
            bad, _, _ = decode_run(cfg, params, prompts, fresh(), 0)
        bad_err, rejected = max_err(bad, want), not close(bad, want, tol)
    print(f"lm full {name}: decode vs prefill {err:.3g} max abs diff at "
          f"{S} positions x B = {B} (tol {tol})"
          + ("" if plant is None else
             f", with the {plant} planted {bad_err:.3g} ("
             f"{'rejected' if rejected else 'within the limit'})")
          + f"; argmax equal at {equal} of {B * S}, held at the {held} whose "
          f"top-2 gap exceeds 2 atol; {ms_tok:.3f} ms a decode token (eager, "
          f"warm, B = {B}) on {card}", flush=True)
    check(bool(torch.isfinite(got).all()), f"{name}: finite logits")
    check(close(got, want, tol), f"{name}: decode vs prefill logits")
    check(ok_tok, f"{name}: argmax where the top-2 gap is clear")
    return {"err": err, "ms_tok": ms_tok, "planted_err": bad_err,
            "rejected": rejected}


def _bytes_of(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def decode_graph_ms(cfg, params, dev, B: int, max_len: int,
                    iters: int = 10) -> float:
    """Device time of one decode token at B rows: ``decode_step`` captured
    once in a CUDA graph and replayed, so the host's cost of issuing its
    ops is out of the measurement. Each replay steps every cache's ``pos``
    back by one, so all of them decode at position ``max_len // 2``."""
    caches = transformer.init_caches(cfg, B, max_len, torch.float32,
                                     device=dev)
    for c in caches.values():
        c["pos"].fill_(max_len // 2)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def step():
        transformer.decode_step(params, cfg, tok, caches)
        for c in caches.values():
            c["pos"].sub_(1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize(dev)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        graph.replay()
    t1.record()
    torch.cuda.synchronize(dev)
    ms = t0.elapsed_time(t1) / iters
    del graph
    return ms


def serve_full(cfg, params, dev, card) -> dict:
    """Greedy ``generate`` of B prompts, replayed teacher-forced; times
    beside the decode bound."""
    B, Sp, new = mp.LM_B, mp.LM_PROMPT, mp.LM_NEW
    prompts = mp.lm_prompts(cfg.vocab, B).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = lm_serve.generate(params, cfg, prompts,
                            lm_serve.ServeConfig(max_new_tokens=new))
    toks = out["tokens"]
    check(tuple(toks.shape) == (B, Sp + new), "generate: token shape")
    caches = transformer.init_caches(cfg, B, Sp + new, torch.float32,
                                     device=dev)
    kv_bytes = _bytes_of(caches)
    logits, _, _ = decode_run(cfg, params, toks[:, :Sp], caches, new,
                              forced=toks[:, Sp:])
    check(bool(torch.isfinite(logits).all()), "generate: finite logits")
    check(torch.equal(logits[:, Sp - 1:-1].argmax(-1).to(torch.int32).cpu(),
                      toks[:, Sp:].cpu()),
          "generate: each greedy token is the replay's argmax")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))
    # a decode token must read every parameter as stored (fp32) but the
    # embedding table, of which it gathers B rows, and the KV cache; the
    # products are 2 x active params x B operations
    n, emb = cfg.n_params, cfg.vocab * cfg.d_model
    need = (n - emb) * 4 + B * cfg.d_model * 4 + kv_bytes
    rl = perf_model.roofline(2.0 * cfg.n_active_params * B, need,
                             precision="bf16")
    bound_ms = max(rl.compute_s, rl.memory_s) * 1e3
    # the program's own traffic: each of those weights is read in fp32,
    # written as a bf16 copy and read again, every token
    cast_gb = (8 * (n - emb) + kv_bytes) / 1e9
    ms = out["decode_s_per_tok"] * 1e3
    graph_ms = (decode_graph_ms(cfg, params, dev, B, Sp + new)
                if dev.type == "cuda" else float("nan"))
    print(f"lm full {cfg.arch} serve: generate B = {B}, {Sp} + {new} greedy "
          f"tokens: prefill (decode path) {out['prefill_s'] * 1e3:.3f} ms, "
          f"decode {ms:.3f} ms a token eager, {graph_ms:.3f} ms of device "
          f"time (one CUDA graph a token); bound {bound_ms:.3f} ms a token "
          f"({need / 1e9:.3f} GB as stored: the fp32 parameters but the "
          f"embedding table, its {B} rows gathered, and the KV cache, on "
          f"{perf_model.H100_SXM.name}); the "
          f"per-use casts move {cast_gb:.3f} GB a token "
          f"({cast_gb / perf_model.H100_SXM.hbm_bytes_per_s * 1e12:.3f} ms "
          f"at the memory rate); peak memory {peak:.2f} GiB; on {card}",
          flush=True)
    return {"decode_ms": ms, "graph_ms": graph_ms, "bound_ms": bound_ms,
            "prefill_ms": out["prefill_s"] * 1e3, "peak_gib": peak}


def long_prefill(cfg, params, dev, card, S: int,
                 plant: str | None = None) -> dict:
    """A prefill of S tokens (B = 1) through ``chunked_attention``'s blocks
    against the same prefill in one block each way, its last-token logits
    and hidden states; with ``plant``, also whether the limit rejects the
    blocked prefill again with that fault."""
    prompts = mp.lm_prompts(cfg.vocab, 1, S).to(dev)
    one = cfg.replace(q_block=S, k_block=S)
    n_q, n_k = -(-S // cfg.q_block), -(-S // cfg.k_block)
    check(n_q > 1 and n_k > 1, "long prefill: several blocks each way")
    transformer.prefill(params, cfg, prompts[:, :cfg.q_block])  # warm up
    sync(dev)
    t0 = time.perf_counter()
    got, h = transformer.prefill(params, cfg, prompts)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    want, h1 = transformer.prefill(params, one, prompts)
    err, h_err = max_err(got, want), max_err(h, h1)
    ok_tok, _, _ = argmax_agrees(got, want, TOL_FULL_BF16)
    bad_errs = rejected = None
    if plant is not None:
        with planted(plant):
            bad, hb = transformer.prefill(params, cfg, prompts)
        bad_errs = (max_err(bad, want), max_err(hb, h1))
        rejected = not (close(bad, want, TOL_FULL_BF16)
                        and close(hb, h1, TOL_FULL_BF16))
    # the work the prefill needs: every block weight's product over S rows,
    # causal attention's two products (2 S^2 h hd over the layers, half of
    # the square), and the last token's unembedding, at the bf16 rate; the
    # bytes: every parameter but the embedding table, and the S rows of it
    # the prompt gathers
    emb = cfg.vocab * cfg.d_model
    blk = cfg.n_params - 2 * emb - cfg.d_model
    att = 2.0 * S * S * cfg.n_heads * cfg.d_head * cfg.n_layers
    flops = 2.0 * blk * S + att + 2.0 * emb
    rl = perf_model.roofline(flops, (cfg.n_params - emb + S * cfg.d_model)
                             * 4, precision="bf16")
    bound_ms = max(rl.compute_s, rl.memory_s) * 1e3
    print(f"lm full {cfg.arch} long prefill: S = {S}, B = 1, "
          f"{cfg.dtype}: {n_q} x {n_k} blocks of {cfg.q_block} x "
          f"{cfg.k_block}; {ms:.3f} ms, {S / ms * 1e3:.0f} tokens/s; bound "
          f"{bound_ms:.3f} ms ({flops / 1e12:.3f} TFLOP at bf16 on "
          f"{perf_model.H100_SXM.name}); against one block: last-token "
          f"logits {err:.3g} max abs diff, hidden states {h_err:.3g} (of "
          f"max abs {float(h1.abs().max()):.3g})"
          + ("" if plant is None else
             f", with the {plant} planted {bad_errs[0]:.3g} and "
             f"{bad_errs[1]:.3g} ("
             f"{'rejected' if rejected else 'within the limit'})")
          + f" (tol {TOL_FULL_BF16}); on {card}", flush=True)
    check(bool(torch.isfinite(got).all()), "long prefill: finite")
    check(close(got, want, TOL_FULL_BF16),
          "long prefill: chunked vs one block, last-token logits")
    check(close(h, h1, TOL_FULL_BF16),
          "long prefill: chunked vs one block, hidden states")
    check(ok_tok, "long prefill: argmax where the top-2 gap is clear")
    return {"ms": ms, "bound_ms": bound_ms, "err": err, "h_err": h_err,
            "planted_errs": bad_errs, "rejected": rejected}


def run_full(arch: str, cfg, dev, card) -> dict:
    gen = torch.Generator(device=dev).manual_seed(mp.LM_SEED)
    t0 = time.perf_counter()
    params = lm_common.init_params(gen, cfg, dev)
    sync(dev)
    print(f"lm full {arch}: {cfg.n_params / 1e9:.3f} B parameters "
          f"({_bytes_of(params) / 1e9:.3f} GB fp32) drawn on {dev} in "
          f"{time.perf_counter() - t0:.2f} s; {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; on "
          f"{card}", flush=True)
    fam = lm_common.family_of(cfg)
    B = mp.LM_SMOKE_B
    prompts = mp.lm_prompts(cfg.vocab, B).to(dev)
    extra = None
    if fam == "whisper":
        extra = torch.randn((B, cfg.n_frames, cfg.d_model), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    # the bf16 scores are planted into both decode comparisons, and only
    # the fp32 one must reject them: in bf16 they hide in the roundings of
    # every product (their reading is printed all the same)
    plant = "bf16 scores" if fam == "transformer" else None
    res = {"f32": decode_vs_prefill(f"{arch} fp32",
                                    cfg.replace(dtype="float32"), params,
                                    prompts, dev, card, TOL_FULL_F32, extra,
                                    plant)}
    check(plant is None or res["f32"]["rejected"],
          f"{arch} fp32: the limit rejects the planted {plant}")
    if fam == "transformer":
        res["bf16"] = decode_vs_prefill(f"{arch} {cfg.dtype}", cfg, params,
                                        prompts, dev, card, TOL_FULL_BF16,
                                        plant=plant)
        res["serve"] = serve_full(cfg, params, dev, card)
        res["long"] = long_prefill(cfg, params, dev, card, mp.LM_LONG,
                                   plant="no rescale")
        check(res["long"]["rejected"],
              "long prefill: the limit rejects the planted no rescale")
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def run(dev: torch.device, card: str) -> dict:
    """The whole LM phase; raises on a failed check."""
    t0 = time.perf_counter()
    out = {"smoke": {}}
    for arch in configs.all_archs():
        out["smoke"][arch] = smoke_arch(
            arch, configs.get(arch).smoke_config(), dev, card)
    out["prune"] = smoke_prune("qwen3_8b", dev, card)
    for arch in mp.LM_FULL:
        out[arch] = run_full(arch, configs.get(arch).config(), dev, card)
    print(f"lm phase: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, card_line(dev))
    print("lm-smoke: OK")
    return out


if __name__ == "__main__":
    main()
