"""Shared by ``tests/test_torch_dryrun_reference*.py``: the port's dry-run
cells (``repro_torch/launch/dryrun.py``) held against the reference's
(``repro/launch/dryrun.py``) at an arch's smoke width, production mesh and
full shape.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when imported, which would reach every later JAX test of a worker
and every process it starts; so its cells run in a subprocess of their own
(one thread, as the port's other subprocess tests), started when a file's
tests start and read when the first test needs it. It returns each cell's
record and its dot FLOPs by loop multiplier, read from the compiled HLO
with the reference analyzer's own parser (the reference's ``flops`` adds
elementwise and reduce FLOPs; the products are what both count alike).

What is held, for each cell:

* ``memory.argument_bytes`` equal to the reference's, byte for byte;
* the product FLOPs a device runs within ``PRODUCT_RTOL`` of the
  reference's dot FLOPs, except where ``PRODUCTS_NAMED`` names a
  difference: there the products outside the named fold site must agree
  within the tolerance, and the site's products stand to the reference's
  in the ratio stated, with its cause;
* the collective bytes of each kind (the port's ``_c10d_functional`` ops
  under the reference's HLO names): port / reference within
  ``COLL_RTOL`` of the ratio ``COLLECTIVES`` states with its cause; a kind
  only the port issues is stated as its share of the reference's total
  collective bytes.

The port's collectives are DTensor's redistributions, and at the models'
sharded sites the explicit collectives of their partitioned forms
(``repro_torch/distributed/partitioned.py``: the SSD loop over heads, the
decode softmax by partials, the vocab-parallel cross-entropy and
embedding lookup, the MoE rows by all-to-all); the ratios below are what
is left of the difference with GSPMD's, measured, each with its cause.
Meshes are ``cpu``-typed fake devices; there DTensor moves ``Shard(i)`` to
``Shard(j)`` by all-gather and chunk (torch's CPU process groups have no
all-to-all), so the port's all-to-alls are the forms' own.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun, hlo_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

#: the port's collective kinds under the reference's HLO names
KINDS = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}

PRODUCT_RTOL = 0.02
COLL_RTOL = 0.05

_NO_PERMUTE = "the port issues no collective-permute"
_SEQ_GATHER = ("DTensor's strategies keep the sequence-sharded activations "
               "and gather them whole where an op needs the sequence")
_RS_BACKWARD = ("DTensor turns a Partial product into its Shard layout by "
                "reduce-scatter, where GSPMD all-reduces it")
_EMBED = ("the embedding table moves from its vocab split to a split of "
          "its columns by all-to-all (partitioned.embed: a training step "
          "has more token rows than a shard has table rows)")

#: (arch, shape, multi_pod) -> {kind: (port / reference, cause)}; a kind
#: the reference lacks: (port / the reference's total, cause)
COLLECTIVES = {
    ("qwen3_8b", "train_4k", False): {
        "all-gather": (1.1795, "both gather the sequence-sharded hidden "
                       "state in every loss chunk (2.15 GB each; the "
                       "chunk's vocab-sharded logits are not gathered: "
                       "partitioned.xent_sum); the port also gathers the "
                       "attention projections' inputs (0.34 GB); "
                       + _SEQ_GATHER),
        "all-reduce": (0.0772, "the loss chunks' max, sum and gold logit "
                       "(partitioned.xent_sum); GSPMD also all-reduces the "
                       "loss chunks' partial products; " + _RS_BACKWARD),
        "all-to-all": (6.96e-6, _EMBED),
        "reduce-scatter": (0.1498, _RS_BACKWARD)},
    ("grok_1_314b", "train_4k", False): {
        "all-gather": (0.3907, "the MoE rows move by all-to-all "
                       "(partitioned.moe_ffn), where GSPMD gathers the "
                       "dispatch tables' rows and their cotangents; both "
                       "gather the loss chunks' hidden state; "
                       + _SEQ_GATHER),
        "all-reduce": (0.0010, "the port's MoE output is a partial sum "
                       "over the F columns, reduce-scattered; "
                       + _RS_BACKWARD),
        "all-to-all": (1.8845, "each (token, k) row goes to the data shard "
                       "of its capacity row and back (T/16 x k rows of D "
                       "a device, in the forward, its recompute and the "
                       "backward); GSPMD's all-to-alls move the tokens' "
                       "columns and the routing tables"),
        "collective-permute": (0.0, _NO_PERMUTE),
        "reduce-scatter": (0.0390, _RS_BACKWARD)},
    ("gemma3_12b", "decode_32k", True): {
        "all-gather": (1.4670, "q, k and v of the new token gathered over "
                       "the kv heads (GSPMD gathers q for the scores and "
                       "the new k/v rows for the cache write as well); "
                       "the K/V caches stay in place"),
        "all-reduce": (0.2177, "the softmax's partial max, sum and P.V "
                       "(partitioned.decode_softmax), as GSPMD's; GSPMD "
                       "also all-reduces the projections' and the norms' "
                       "partials and the embedding's masked rows, which "
                       "the port reduce-scatters or does not make"),
        "all-to-all": (0.0, "a decode step's few token rows are looked "
                       "up shard by shard and reduce-scattered "
                       "(partitioned.embed), not moved by all-to-all"),
        "collective-permute": (0.0, _NO_PERMUTE),
        "reduce-scatter": (0.2050, "the embedding's looked-up rows "
                           "(partitioned.embed); " + _RS_BACKWARD)},
    ("mamba2_130m", "prefill_32k", False): {
        "all-gather": (3.0250, "the group-shared B and C taken whole for "
                       "the SSD loop over heads, as GSPMD takes them "
                       "(33.6 MB); the port also gathers the gated output "
                       "for out_proj (67.1 MB); " + _SEQ_GATHER),
        "all-reduce": (0.0, "the projections' partials go by reduce-scatter"
                       " (" + _RS_BACKWARD + ")"),
        "all-to-all": (0.7090, "x and dt to the head split and y back, "
                       "once a layer (partitioned.ssd_chunked); GSPMD "
                       "passes the chunk states by collective-permute"),
        "collective-permute": (0.0, _NO_PERMUTE),
        "reduce-scatter": (0.9343, _RS_BACKWARD)},
}

#: a cell whose products differ: the fold site, the reference's loop
#: multiplier of the same loop, port / reference there, and the cause
#: (none now: the SSD loop runs on a shard's heads, as GSPMD's does)
PRODUCTS_NAMED: dict = {}

REF_SCRIPT = r"""
import gzip, json, os, sys
from collections import defaultdict
from repro import configs
from repro.launch import dryrun, hlo_analysis as H

def dots_by_mult(hlo):
    comps = H._parse(hlo)
    out, stack = defaultdict(float), []
    def visit(name, mult):
        comp = comps.get(name)
        if comp is None or name in stack:
            return
        stack.append(name)
        for op in comp.ops:
            k = op.kind
            if k == "dot":
                out[mult] += mult * H._dot_flops(op, comp)
            if k == "fusion":
                mc = H._CALLS_RE.search(op.line)
                if mc:
                    visit(mc.group(1), mult)
            elif k == "while":
                trips = H._trip_count(op, comps)
                mw = H._WHILE_RE.search(op.line)
                if mw:
                    visit(mw.group(1), mult * trips)
                    visit(mw.group(2), mult * trips)
            elif k in ("call", "conditional", "custom-call", "reduce",
                       "sort", "scatter", "map", "reduce-window",
                       "select-and-scatter", "reduce-scatter", "all-reduce"):
                mt = H._TO_APPLY_RE.search(op.line) or H._CALLS_RE.search(
                    op.line)
                if mt:
                    visit(mt.group(1), mult)
        stack.pop()
    visit(comps["__entry__"].name, 1.0)
    return {repr(m): f for m, f in out.items()}

cells, tmp = json.loads(sys.argv[1]), sys.argv[2]
out = {}
for arch, shape, mp in cells:
    path = os.path.join(tmp, f"{arch}_{shape}_{mp}.hlo.gz")
    r = dryrun.run_cell(arch, shape, multi_pod=mp, save_hlo=path,
                        override_cfg=configs.get(arch).smoke_config())
    with gzip.open(path, "rt") as f:
        r["dots_by_mult"] = dots_by_mult(f.read())
    out[f"{arch}/{shape}/{mp}"] = r
print("RESULT " + json.dumps(out))
"""


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", **ONE_THREAD)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("XLA_FLAGS", None)
    return env


class Reference:
    """The reference's cells, computed in a subprocess started at once and
    read on first use."""

    def __init__(self, cells, tmp):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(cells), str(tmp)],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.cells = None

    def __getitem__(self, cell):
        if self.cells is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            line = [x for x in out.splitlines() if x.startswith("RESULT ")]
            self.cells = json.loads(line[-1][len("RESULT "):])
        arch, shape, mp = cell
        return self.cells[f"{arch}/{shape}/{mp}"]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()


def port_cell(cell, tmp):
    """The port's record of ``cell`` and its trace."""
    arch, shape, mp = cell
    path = os.path.join(str(tmp), f"{arch}_{shape}_{mp}.trace.json.gz")
    try:
        rec = dryrun.run_cell(arch, shape, multi_pod=mp,
                              override_cfg=configs.get(arch).smoke_config(),
                              device="cpu", save_hlo=path)
    finally:
        dryrun.destroy_world()
    import gzip
    with gzip.open(path, "rt") as f:
        return rec, json.load(f)


def check_argument_bytes(rec, ref):
    assert rec["status"] == ref["status"] == "ok"
    assert rec["memory"]["local_argument_bytes"] == rec["memory"][
        "argument_bytes"]
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]


def _products(ops) -> float:
    return sum(hlo_analysis.analyze({"ops": ops})["flops_by_dtype"].values())


def check_products(cell, rec, trace, ref):
    """The products a device runs against the reference's dots."""
    ref_dots = sum(ref["dots_by_mult"].values())
    port = sum(rec["per_device"]["flops_by_dtype"].values())
    named = PRODUCTS_NAMED.get(cell)
    if named is None:
        assert port == pytest.approx(ref_dots, rel=PRODUCT_RTOL)
        return
    site, ref_mult, ratio, _cause = named
    inside = _products([e for e in trace["ops"] if e.get("site") == site])
    outside = _products([e for e in trace["ops"] if e.get("site") != site])
    assert inside + outside == pytest.approx(port, rel=1e-12)
    ref_inside = ref["dots_by_mult"].get(repr(ref_mult), 0.0)
    assert ref_inside > 0
    assert outside == pytest.approx(ref_dots - ref_inside, rel=PRODUCT_RTOL)
    assert inside / ref_inside == pytest.approx(ratio, rel=PRODUCT_RTOL)


def check_collectives(cell, rec, ref):
    """Each collective kind's bytes against the reference's, as stated."""
    port: dict = {}
    for op, b in rec["per_device"]["collectives_by_op"].items():
        port[KINDS[op]] = port.get(KINDS[op], 0.0) + b
    theirs = ref["per_device"]["collectives_by_op"]
    want = COLLECTIVES[cell]
    assert set(want) == set(port) | set(theirs), (port, theirs)
    total = sum(theirs.values())
    for kind, (ratio, cause) in want.items():
        got = (port.get(kind, 0.0) / theirs[kind] if kind in theirs
               else port[kind] / total)
        assert got == pytest.approx(ratio, rel=COLL_RTOL, abs=1e-9), (
            kind, got, cause)
