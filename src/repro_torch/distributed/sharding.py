"""Sharding rules for the language models: parameter paths -> specs.

Port of ``repro.distributed.sharding``, keeping its names and its rules.
Two weight layouts, selected per architecture by size (configs set
``SHARD_MODE``):

  * ``tp``     — Megatron-style: weights replicated over the DP axes,
                 tensor-parallel over ``model``; optimizer moments
                 additionally shard over ``data`` (ZeRO-1).
  * ``fsdp2d`` — 2-D sharded weights (data x model) for models whose
                 parameters cannot be DP-replicated (dbrx-132B, grok-314B).

A spec is a tuple with one entry a dimension: an axis name, a tuple of
names (the dimension split over their product, the first name major), or
None (not split) — the reference's ``PartitionSpec`` entry by entry, and
the form ``distributed/tgn_sharding.py`` uses. Leaf names come from
``models/layers.py``; a leaf's path is its dot path
(``repro_torch.tree.flatten_with_path``). Stacked block dims (leading
``n_blocks`` axes under blocks./layers./enc./dec.) are absorbed by
left-padding the spec with None up to the leaf's rank.

As in the reference, ``_validate`` drops (and re-homes) axes against the
fixed production sizes ``AXIS_SIZES``, not against the mesh a spec is
later placed on, so a spec on the (1, 1) host mesh still names ``data``
and ``model``.

Placement is single-controller, as the reference's is: ``make_shardings``
gives each leaf a ``NamedSharding`` over a mesh
(``tgn_sharding.TenantMesh``: named axes over an array of devices, which
may repeat), and its ``place`` cuts a tensor into the piece each mesh
position holds (``ShardedTensor``), or, when no dimension is split,
returns the tensor on the mesh's device. ``checkpoint.restore(...,
shardings=)`` calls ``place`` leaf by leaf.

The models call ``constrain(x, "carry")`` at block boundaries. With no
rules installed it is the identity; with rules it resolves the rule's
spec against the mesh the rules were installed with (``activation_spec``)
and returns ``x`` itself, or, given a DTensor (``launch/dryrun.py``), the
DTensor redistributed to that spec (``placements``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_mod

Tree = Any

# (regex on dot-path, tp spec, fsdp2d spec) — first match wins; specs are
# for the trailing dims of the logical weight (leading stacked dims padded
# None).
_RULES = [
    # MoE experts (E, D, F) / (E, F, D): EP over model when E divides it,
    # else TP inside the expert — decided per leaf in _moe_spec.
    (r"\.router$", (), ()),
    (r"moe\.w_(gate|up)$", "moe_in", "moe_in"),
    (r"moe\.w_down$", "moe_out", "moe_out"),
    # embeddings
    (r"\.embed$", ("model", None), ("model", "data")),
    (r"\.unembed$", (None, "model"), ("data", "model")),
    (r"\.pos_dec$", (), ()),
    # attention / mlp / recurrent projections: (D_in, D_out) column-parallel
    (r"\.(wq|wk|wv|w_gate|w_up|in_proj|w_gate_in|w_main_in)$",
     (None, "model"), ("data", "model")),
    # row-parallel back-projections: (D_out, D_in)
    (r"\.(wo|w_down|out_proj|w_out)$", ("model", None), ("model", "data")),
    # RG-LRU block-diagonal gates (H, bw, bw)
    (r"\.(w_a|w_x)$", ("model", None, None), ("model", None, None)),
    # small/1-D leaves: replicate
    (r".*", (), ()),
]


def _moe_spec(kind: str, shape, n_model: int) -> tuple:
    E = shape[-3]
    if E % n_model == 0:
        # expert parallelism
        return (("model", "data", None) if kind == "moe_in"
                else ("model", None, "data"))
    # TP inside each expert (grok: 8 experts on a 16-way model axis)
    return ((None, "data", "model") if kind == "moe_in"
            else (None, "model", "data"))


def spec_for(path: str, shape, mode: str, n_model: int) -> tuple:
    for pat, tp_spec, fsdp_spec in _RULES:
        if re.search(pat, path):
            spec = tp_spec if mode == "tp" else fsdp_spec
            if isinstance(spec, str):
                spec = _moe_spec(spec, shape, n_model)
            # left-pad for stacked dims
            pad = len(shape) - len(spec)
            if pad > 0:
                spec = (None,) * pad + tuple(spec)
            elif pad < 0:  # 1-D leaf matched a 2-D rule (shouldn't happen)
                spec = ()
            # drop axes that don't divide and would waste padding badly
            return _validate(spec, shape, n_model)
    raise AssertionError("unreachable")


AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _axes(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _axis_size(ax) -> int:
    n = 1
    for a in _axes(ax):
        n *= AXIS_SIZES.get(a, 1)
    return n


def _validate(spec: tuple, shape, n_model: int) -> tuple:
    """Drop axes whose dim doesn't divide by the production axis size,
    then greedily re-home each dropped axis onto another still-unsharded
    dim that does divide (e.g. a 49155-row vocab embedding falls back to
    sharding its d_model dim)."""
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    dropped = []
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None:
            continue
        if dim % _axis_size(ax) != 0 or dim < _axis_size(ax):
            dropped.append(ax)
            entries[i] = None
    for ax in dropped:
        for i, (dim, cur) in enumerate(zip(shape, entries)):
            if cur is None and dim % _axis_size(ax) == 0 \
                    and dim >= _axis_size(ax):
                entries[i] = ax
                break
    return tuple(entries)


def param_specs(tree: Tree, mode: str, n_model: int = 16) -> Tree:
    """A spec tree congruent to ``tree`` (leaves with a ``shape``)."""
    flat = tree_mod.flatten_with_path(tree)
    return tree_mod.unflatten(tree, [
        spec_for(path, tuple(leaf.shape), mode, n_model)
        for path, leaf in flat])


def zero1_specs(tree: Tree, mode: str, n_model: int = 16,
                dp_axis: str = "data") -> Tree:
    """Optimizer-moment specs: params' specs with the first free (None) dim
    of each >=2-D leaf sharded over the DP axis (ZeRO-1; the reference's
    test is ``dim >= 16 and dim % 16 == 0`` whatever the axis). fsdp2d
    weights are already fully sharded — moments just mirror them."""
    if mode == "fsdp2d":
        return param_specs(tree, mode, n_model)
    out = []
    for path, leaf in tree_mod.flatten_with_path(tree):
        shape = tuple(leaf.shape)
        entries = list(spec_for(path, shape, mode, n_model))
        if len(shape) >= 2:
            for i, (dim, ax) in enumerate(zip(shape, entries)):
                if ax is None and dim >= 16 and dim % 16 == 0:
                    entries[i] = dp_axis
                    break
        out.append(tuple(entries))
    return tree_mod.unflatten(tree, out)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def dp_axes(mesh):
    """The data-parallel axes of a mesh (('pod','data') on multipod)."""
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def batch_spec(mesh, batch: int, ndim: int) -> tuple:
    """Shard the leading batch dim over as many DP axes as divide it."""
    axes = [a for a in mesh.axis_names if a in ("pod", "data")]
    use = []
    prod = 1
    for a in axes:
        n = mesh.shape[a]
        if batch % (prod * n) == 0:
            use.append(a)
            prod *= n
    lead = tuple(use) if len(use) > 1 else (use[0] if use else None)
    return (lead,) + (None,) * (ndim - 1)


def cache_spec(mesh, leaf_shape, batch: int) -> tuple:
    """KV-cache leaves: (L?, B, S, kv, hd) -> batch over DP (when
    divisible), sequence over ``model``. Small leaves replicate."""
    nd = len(leaf_shape)
    if nd <= 1:
        return ()
    # find the batch dim: first dim equal to `batch`
    entries = [None] * nd
    try:
        b_idx = next(i for i, d in enumerate(leaf_shape) if d == batch)
    except StopIteration:
        return ()
    entries[b_idx] = batch_spec(mesh, batch, 1)[0]
    n_model = mesh.shape["model"]
    # the dim right after batch is sequence/window/state: shard over model
    if b_idx + 1 < nd and leaf_shape[b_idx + 1] % n_model == 0 \
            and leaf_shape[b_idx + 1] >= n_model:
        entries[b_idx + 1] = "model"
    return tuple(entries)


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------


def _mesh_size(mesh, ax) -> int:
    return math.prod(int(mesh.shape.get(a, 1)) for a in _axes(ax))


def _splits(mesh, spec: tuple, shape) -> list:
    """``[(dim, axes), ...]`` of the dimensions ``spec`` splits on ``mesh``
    (axes of size 1, or absent from the mesh, split nothing)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or _mesh_size(mesh, ax) == 1:
            continue
        n = _mesh_size(mesh, ax)
        if shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways over {ax}")
        out.append((i, _axes(ax)))
    return out


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of the piece of a ``shape`` leaf each device holds."""
    out = list(shape)
    for i, axes in _splits(mesh, spec, shape):
        out[i] //= _mesh_size(mesh, axes)
    return tuple(out)


def _piece_index(mesh, axes: tuple, coord: dict) -> int:
    """Which of a dimension's pieces the mesh position ``coord`` holds:
    its coordinates along ``axes``, the first axis major."""
    k = 0
    for a in axes:
        k = k * int(mesh.shape[a]) + coord[a]
    return k


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A logical tensor as the pieces the mesh positions hold:
    ``shards[pos]`` is position ``pos``'s piece (``shards`` has the mesh's
    shape). Positions that hold the same piece on the same device share
    one tensor, and the pieces on one device are views of one copy."""
    mesh: Any
    spec: tuple
    shape: tuple
    shards: np.ndarray

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    @property
    def shard_shape(self) -> tuple:
        return tuple(self.shards.flat[0].shape)

    def full(self, device="cpu") -> torch.Tensor:
        """The logical tensor, assembled on ``device`` from the pieces."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        splits = _splits(self.mesh, self.spec, self.shape)
        for pos in np.ndindex(self.shards.shape):
            coord = dict(zip(self.mesh.axis_names, pos))
            view = out
            for i, axes in splits:
                n = self.shape[i] // _mesh_size(self.mesh, axes)
                view = view.narrow(i, _piece_index(self.mesh, axes, coord)
                                   * n, n)
            view.copy_(self.shards[pos])
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: ``spec`` over ``mesh``."""
    mesh: Any
    spec: tuple

    def place(self, t: torch.Tensor):
        """``t`` on the mesh: the tensor itself on the mesh's first device
        when the spec splits nothing here, else a ``ShardedTensor`` of
        the piece at every mesh position (each split dimension cut over
        its axes, the first axis major, as JAX lays a ``NamedSharding``
        out)."""
        mesh = self.mesh
        spec = tuple(self.spec) + (None,) * (t.ndim - len(self.spec))
        splits = _splits(mesh, spec, t.shape)
        if not splits:
            return t.to(mesh.devices.reshape(-1)[0])
        on = {d: t.to(d) for d in mesh.distinct_devices}
        pieces: dict = {}
        shards = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(mesh.devices.shape):
            coord = dict(zip(mesh.axis_names, pos))
            dev = mesh.devices[pos]
            idx = tuple(_piece_index(mesh, axes, coord) for _, axes in splits)
            if (dev, idx) not in pieces:
                piece = on[dev]
                for (i, axes), k in zip(splits, idx):
                    n = t.shape[i] // _mesh_size(mesh, axes)
                    piece = piece.narrow(i, k * n, n)
                pieces[dev, idx] = piece
            shards[pos] = pieces[dev, idx]
        return ShardedTensor(mesh, spec, tuple(t.shape), shards)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def make_shardings(mesh, spec_tree: Tree) -> Tree:
    """A spec tree as a tree of ``NamedSharding``s over ``mesh``."""
    return tree_mod.map(lambda s: NamedSharding(mesh, s), spec_tree,
                        is_leaf=_is_spec)


def per_device_bytes(tree: Tree, spec_tree: Tree, mesh,
                     itemsize: int | None = None) -> int:
    """The bytes one device holds of ``tree`` (leaves with a ``shape`` and
    a ``dtype``, e.g. ``meta`` tensors) placed by ``spec_tree`` on
    ``mesh``: spec arithmetic, nothing allocated. ``itemsize`` overrides
    the leaves' own."""
    specs = tree_mod.leaves(spec_tree, is_leaf=_is_spec)
    total = 0
    for leaf, spec in zip(tree_mod.leaves(tree), specs):
        size = itemsize or leaf.element_size()
        total += math.prod(shard_shape(tuple(leaf.shape), spec, mesh)) * size
    return total


# ---------------------------------------------------------------------------
# activation sharding constraints (sequence parallelism)
# ---------------------------------------------------------------------------
#
# Models call ``constrain(x, "carry")`` at block boundaries. In the
# reference a launcher installs rules inside a mesh context and the carry
# is pinned to a (dp, model, None) layout; off (empty rules) it is a no-op.

_ACTIVATION_RULES: dict[str, tuple] = {}
_ACTIVATION_MESH = None


def set_activation_rules(rules: dict[str, tuple], mesh=None) -> None:
    """Install ``rules`` (kind -> spec), resolved against ``mesh`` (the
    reference's current mesh); ``{}`` removes them."""
    global _ACTIVATION_MESH
    _ACTIVATION_RULES.clear()
    _ACTIVATION_RULES.update(rules)
    _ACTIVATION_MESH = mesh if rules else None


def activation_spec(shape, kind: str) -> tuple | None:
    """The installed rule for ``kind`` resolved for a ``shape`` activation
    as the reference's ``constrain`` resolves it: padded with None to the
    rank, each axis dropped whose mesh size does not divide its dim (all
    kept without a mesh). None when no rule is installed for ``kind``."""
    spec = _ACTIVATION_RULES.get(kind)
    if spec is None:
        return None
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    mesh = _ACTIVATION_MESH
    fixed = []
    for dim, ax in zip(shape, entries[:len(shape)]):
        if ax is None or mesh is None:
            fixed.append(ax)
            continue
        size = _mesh_size(mesh, ax)
        fixed.append(ax if size > 0 and dim % size == 0 else None)
    return tuple(fixed)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The identity without rules. With rules the spec is resolved
    (``activation_spec``): a DTensor (the dry run's) is redistributed to
    it, as ``with_sharding_constraint`` pins the reference's layout; a
    plain tensor, on one device, already holds every piece of it and is
    returned itself."""
    if _ACTIVATION_RULES:
        spec = activation_spec(tuple(x.shape), kind)
        if spec is not None and type(x) is not torch.Tensor:
            from torch.distributed.tensor import DTensor
            if isinstance(x, DTensor):
                return x.redistribute(x.device_mesh, placements(
                    spec, x.device_mesh.mesh_dim_names))
    return x


def placements(spec: tuple, axis_names) -> list:
    """``spec`` as DTensor placements over a mesh with ``axis_names``:
    ``Shard(dim)`` on each mesh dimension the spec names for ``dim``,
    ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axis_names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in _axes(ax):
            if a in axis_names:
                out[axis_names.index(a)] = Shard(dim)
    return out
