"""Placement: which dim of each leaf lies over which mesh axis.

Counterpart of :mod:`repro.launch.sharding`, over the port's trees.  A spec
is a tuple with one entry per dim of a leaf: None (the dim is whole on
every rank), an axis name, or a tuple of axis names (the dim split over
their product, the first outermost) -- the reference's ``PartitionSpec``
as a plain tuple.  ``mesh`` is the axis sizes, ``{"pod", "data", "pipe",
"tp"}`` (:func:`repro_torch.launch.mesh.mesh_shape`).

Conventions (the reference's):
  * stage parameters ``[n_stages, L_per_stage, ...]``: ``pipe`` on axis 0;
    FSDP (``data``, or ``(pod, data)`` when ``pod > 1``) on the input dim
    and ``tp`` on the output dim of a matrix, the reverse for the output
    projections (:data:`_TP_IN`); MoE experts over ``tp`` on the expert
    dim; a wide vector (``>= 1024``) over FSDP.  A dim that does not divide
    stays whole (replicated over that axis).
  * the embedding table: ``d_model`` over the data axes, or else ``tp``;
    the head ``[D, V]``: vocab over ``tp``.
  * optimizer state (moments, master weights, the error-feedback residual)
    mirrors its parameter leaf for leaf.
  * batches: the leading dim over ``(pod, data)``.
  * KV caches ``[n_stages, L, m, mb, slots, kv, hd]``: ``pipe``, the
    micro-batch over ``(pod, data)`` when it divides (else the slots over
    ``data``: the sequence-sharded decode cache, ROADMAP A9b), kv heads
    over ``tp``.

The port keeps a stage tree stacked ``[n_chunks, ...]`` on each pipe rank:
axis 0 is its share of the ``pipe`` axis and every other dim is placed as
the spec says (:func:`shard`).  Where the reference leaves the reshards to
GSPMD, the port gathers: the FSDP axes once a step or at each stage
application (:func:`gather_stage_weights`, ``models.lm``), the ``tp``
axis where a split does not fall on head boundaries (``models.layers``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.tree import tree_map

BATCH = ("pod", "data")

# per-leaf-name TP placement: which trailing dim gets 'tp'
_TP_IN = {"wo", "wd", "wv_cm"}        # output projections: tp on input dim
_EXPERT = {"wg", "wu", "wd"}          # under a "moe" subtree: dim0 = experts

Spec = Tuple[Any, ...]
Mesh = Dict[str, int]


def _axsize(mesh: Mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= _axsize(mesh, n)
        return out
    return mesh.get(name, 0)


def _fit(dim: int, mesh: Mesh, axis) -> Any:
    n = _axsize(mesh, axis)
    return axis if n > 0 and dim % n == 0 else None


def stage_param_spec(path: Tuple[str, ...], shape, mesh: Mesh) -> Spec:
    """The spec of one stacked stage-parameter leaf."""
    name = path[-1]
    in_moe = "moe" in path
    nd = len(shape)
    rest = [None] * (nd - 2)
    fsdp = ("pod", "data") if _axsize(mesh, "pod") > 1 else "data"
    if nd >= 4 and in_moe and name in _EXPERT:
        rest[0] = _fit(shape[2], mesh, "tp")
        rest[1] = _fit(shape[3], mesh, fsdp) or _fit(shape[3], mesh, "data")
    elif nd == 4:
        din, dout = shape[2], shape[3]
        if name in _TP_IN:
            rest[0] = _fit(din, mesh, "tp")
            rest[1] = _fit(dout, mesh, fsdp) or _fit(dout, mesh, "data")
        else:
            rest[0] = _fit(din, mesh, fsdp) or _fit(din, mesh, "data")
            rest[1] = _fit(dout, mesh, "tp")
    elif nd == 3 and shape[2] >= 1024:
        rest[0] = _fit(shape[2], mesh, fsdp) or _fit(shape[2], mesh, "data")
    return ("pipe", None, *rest)


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, mesh: Mesh) -> Dict[str, Any]:
    """Specs for a ``{"embed", "stages", "head"}`` tree (leaves: tensors,
    meta tensors, or anything with a ``shape``)."""
    def embed_spec(_, leaf):
        if len(leaf.shape) == 2:
            d = leaf.shape[1]
            return (None, _fit(d, mesh, BATCH) or _fit(d, mesh, "data")
                    or _fit(d, mesh, "tp"))
        return ()

    def head_spec(_, leaf):
        if len(leaf.shape) == 2:
            return (None, _fit(leaf.shape[1], mesh, "tp"))
        return ()

    out = {}
    for top, sub in params.items():
        if top == "stages":
            out[top] = _map_path(
                lambda p, l: stage_param_spec(p, tuple(l.shape), mesh), sub)
        elif top == "embed":
            out[top] = _map_path(embed_spec, sub)
        else:
            out[top] = _map_path(head_spec, sub)
    return out


def opt_state_specs(pspecs, *, with_ef: bool = False) -> Dict[str, Any]:
    """The optimizer state's specs by field (``optim.OptState``): the
    moments, the master weights and (with ``with_ef``) the error-feedback
    residual mirror the parameters; the step and the guard counters are
    replicated."""
    return {"step": (), "mu": pspecs, "nu": pspecs, "master": pspecs,
            "ef": pspecs if with_ef else (), "skipped": (), "good": (),
            "scale": ()}


def batch_specs(batch_proto, mesh: Optional[Mesh] = None) -> Any:
    def spec(leaf):
        nd = len(leaf.shape)
        if mesh is not None:
            ax = (_fit(leaf.shape[0], mesh, BATCH)
                  or _fit(leaf.shape[0], mesh, "data"))
            return (ax, *([None] * (nd - 1)))
        return (BATCH, *([None] * (nd - 1)))
    return tree_map(spec, batch_proto)


def cache_specs(cache_proto, mesh: Mesh, *, seq_shard: bool = False) -> Any:
    """``[n_stages, L, m, mb, ...]`` resident cache specs (leaves: anything
    with a ``shape``)."""
    def spec(leaf):
        shape = tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)
        nd = len(shape)
        rest = [None] * (nd - 4)
        mb = shape[3] if nd > 3 else 0
        mb_ax = None
        if mb and mb % max(_axsize(mesh, BATCH), 1) == 0 and \
                _axsize(mesh, BATCH) > 1 and not seq_shard:
            mb_ax = BATCH
        elif nd >= 6:
            rest[0] = _fit(shape[4], mesh, "data")
        if nd >= 7:
            rest[1] = _fit(shape[5], mesh, "tp")
        if nd == 3:
            return ("pipe",)
        return ("pipe", None, None, mb_ax, *rest)
    return tree_map(spec, cache_proto)


def drop_fsdp(spec: Spec) -> Spec:
    """Remove the data / pod (FSDP) axes from a spec, keeping pipe / tp."""
    def clean(e):
        if isinstance(e, (tuple, list)):
            kept = tuple(x for x in e if x not in ("data", "pod"))
            return kept if kept else None
        return None if e in ("data", "pod") else e
    return tuple(clean(e) for e in spec)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim of a leaf that lies over ``axis`` (None: replicated over
    it)."""
    for d, e in enumerate(spec):
        if axis in _names(e):
            return d
    return None


def fsdp_group(spec: Spec) -> Optional[Tuple[int, str]]:
    """``(dim, group)`` of a spec's FSDP placement: the dim over ``data``
    and the mesh group that holds its blocks in order (``replica`` for
    ``(pod, data)``, ``data`` for ``data`` alone), or None."""
    for d, e in enumerate(spec):
        names = _names(e)
        if "data" in names:
            return d, ("replica" if "pod" in names else "data")
    return None


def block_index(entry, coords: Dict[str, int], mesh: Mesh) -> Tuple[int, int]:
    """``(index, count)`` of a rank's block on a dim placed over
    ``entry``: the axes' coordinates, the first outermost."""
    idx, n = 0, 1
    for name in _names(entry):
        idx = idx * mesh[name] + coords[name]
        n *= mesh[name]
    return idx, n


def shard(full, spec: Spec, coords: Dict[str, int], mesh: Mesh,
          skip=("pipe",)):
    """This rank's block of ``full`` under ``spec`` (a view); axes in
    ``skip`` are left whole (a stage tree's axis 0 is already the pipe
    rank's share)."""
    out = full
    for d, e in enumerate(spec):
        if e is None or set(_names(e)) & set(skip):
            continue
        i, n = block_index(e, coords, mesh)
        size = full.shape[d] // n
        out = out.narrow(d, i * size, size)
    return out


def local_shape(shape, spec: Spec, mesh: Mesh, skip=("pipe",)):
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is not None and not set(_names(e)) & set(skip):
            out[d] //= block_index(e, {a: 0 for a in mesh}, mesh)[1]
    return tuple(out)


def shard_tree(tree, specs, coords, mesh: Mesh):
    """:func:`shard` leaf by leaf; every block cloned (it owns its
    storage, the whole leaf can be freed)."""
    return tree_map(lambda a, s: shard(a, s, coords, mesh).clone(), tree,
                    specs)


def gather_stage_weights(stages, specs, mesh_view, cls: str = "fsdp_gather"):
    """gather_weights_once: every stage leaf joined over its FSDP axes
    (``drop_fsdp`` of its spec), once a step; the gradients of the joined
    weights are reduce-scattered once on the way out
    (``launch.steps``)."""
    def one(a, spec):
        fg = fsdp_group(spec)
        if fg is None:
            return a
        d, group = fg
        return mesh_view.axes[group].cat(a, d, cls)
    return tree_map(one, stages, specs)


def per_rank_buffer_bytes(tplan, carry_bytes: int,
                          resid_bytes_per_slot: int = 0) -> dict:
    """Tick-loop buffer accounting per pipe rank, from the plan: the bytes
    each rank's specialized program declares (``plan.specialize``: its
    park / backward-inbox / residual slot high-water times bytes a slot)
    beside the rank-uniform allocation (every rank at the ring-max
    depth)."""
    from repro_torch.core import plan as plan_lib

    progs = [plan_lib.specialize(tplan, r) for r in range(tplan.n_ranks)]
    per_rank = [p.park_depth * carry_bytes + p.b_inbox_depth * carry_bytes
                + p.resid_depth * resid_bytes_per_slot for p in progs]
    uniform = tplan.n_ranks * (
        (tplan.park_depth + tplan.b_inbox_depth) * carry_bytes
        + tplan.resid_depth * resid_bytes_per_slot)
    return {
        "per_rank_park_slots": [p.park_depth for p in progs],
        "per_rank_resid_slots": [p.resid_depth for p in progs],
        "per_rank_buffer_bytes": per_rank,
        "uniform_max_buffer_bytes_per_rank": (
            (tplan.park_depth + tplan.b_inbox_depth) * carry_bytes
            + tplan.resid_depth * resid_bytes_per_slot),
        "total_buffer_bytes": {"mpmd_declared": sum(per_rank),
                               "spmd_uniform": uniform},
    }
