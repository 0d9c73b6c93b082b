"""Logical-axis sharding: named axes on every tensor dim -> a spec -> DTensor
placements on a ``DeviceMesh``.

The production mesh is `(data, model)` single-pod or `(pod, data, model)`
multi-pod.  Logical axes map as:

- batch        -> (pod, data)        activation data parallelism
- embed        -> data               FSDP/ZeRO-3-style parameter + optimizer
                                     state sharding (gathered per layer)
- vocab/heads/ffn/experts/ssm_inner
               -> model              tensor / expert parallelism
- kv_seq       -> model              decode KV-cache length sharding
- seq          -> None (or data for sequence parallelism in prefill)

Rules are a plain dict so schemes can be swapped without touching model
code.  A spec (``PS``) is the reference's PartitionSpec in plain Python: a
tuple with one entry per tensor dim, each ``None``, a mesh-axis name, or a
tuple of names (the dim split over several mesh axes, major to minor), and
trailing ``None``s dropped.  ``placements`` gives its inverse view, one
``Shard(d)`` / ``Replicate()`` per mesh dim, which ``distribute_tensor``
takes.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, or a stand-in in tests); ``None`` means all three
production axes, as in the reference.
"""
from __future__ import annotations

import math

import torch

AxisRules = dict[str, object]   # logical axis -> mesh axis | tuple | None

PRODUCTION_TP = 16              # model-axis size of the production meshes

DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",           # FSDP weight shard axis
    "embed_table": None,       # embedding table embed dim (gather-friendly)
    "embed_act": None,         # activations' embed dim stays replicated
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",       # sanitized to None when KV % model != 0
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "expert_cap": None,
    "ssm_inner": "model",      # mamba inner channels (heads)
    "ssm_state": None,
    "kv_seq": "model",         # decode-time KV cache length
    "frames": None,
    "conv": None,
}

# Alternative rule sets (the reference's perf hillclimb).
SEQ_PARALLEL_RULES: AxisRules = dict(DEFAULT_RULES, seq="data", batch=("pod",))
NO_FSDP_RULES: AxisRules = dict(DEFAULT_RULES, embed=None)
TP_ONLY_RULES: AxisRules = dict(DEFAULT_RULES, embed=None, batch=("pod", "data"))
# pure data parallelism over every mesh axis: zero TP activation all-reduces,
# one grad all-reduce per step; only for models whose params+opt fit per chip
DP_ONLY_RULES: AxisRules = dict(
    DEFAULT_RULES, embed=None, vocab=None, heads=None, kv_heads=None,
    ffn=None, experts=None, ssm_inner=None, kv_seq=None,
    batch=("pod", "data", "model"))


class PS(tuple):
    """A PartitionSpec: ``PS("data", None, ("pod", "model"))``.  Trailing
    ``None`` entries are dropped, so equal shardings compare equal."""

    def __new__(cls, *entries):
        out = [tuple(e) if isinstance(e, list) else e for e in entries]
        while out and out[-1] is None:
            out.pop()
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return f"PS{tuple(self)!r}"


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_axes(mesh) -> set[str]:
    return set(mesh.mesh_dim_names) if mesh is not None \
        else {"pod", "data", "model"}


def logical_spec(logical: tuple[str | None, ...], rules: AxisRules | None = None,
                 mesh=None) -> PS:
    """Map a tuple of logical axis names to a spec.

    Mesh axes not present in the mesh (e.g. 'pod' on the single-pod mesh) are
    dropped, so the same rules serve both meshes; each mesh axis is used at
    most once.
    """
    rules = rules or DEFAULT_RULES
    present = _mesh_axes(mesh)
    used: set[str] = set()
    out: list[object] = []
    for name in logical:
        target = None if name is None else rules.get(name)
        if target is None:
            out.append(None)
        elif isinstance(target, (tuple, list)):
            axes = tuple(a for a in target if a in present and a not in used)
            used.update(axes)
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        elif target in present and target not in used:
            used.add(target)
            out.append(target)
        else:
            out.append(None)
    return PS(*out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PS) and all(
        isinstance(e, str) or e is None for e in x)


def _map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def spec_tree(logical_tree, rules: AxisRules | None = None, mesh=None):
    """Map a tree (dicts, lists) of logical-axis tuples to a tree of specs."""
    return _map(lambda lg: logical_spec(lg, rules, mesh), logical_tree,
                _is_logical)


def sanitize_spec(spec: PS, shape: tuple[int, ...], mesh) -> PS:
    """Drop mesh axes whose size doesn't divide the dim (placed arrays need
    exact divisibility, as the reference's jit in/out shardings do); of a
    tuple entry the longest dividing prefix is kept."""
    sizes = _axis_sizes(mesh)
    out: list[object] = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept: list[str] = []
        s = 1
        for a in axes:
            if shape[i] % (s * sizes[a]) != 0:
                break
            kept.append(a)
            s *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return PS(*out)


def sanitize_tree(spec_tree, abstract_tree, mesh):
    """Sanitize a spec tree against a matching tree of tensors (real, meta
    or fake: only ``.shape`` is read)."""
    if isinstance(spec_tree, PS):
        return sanitize_spec(spec_tree, tuple(abstract_tree.shape), mesh)
    if isinstance(spec_tree, dict):
        return {k: sanitize_tree(v, abstract_tree[k], mesh)
                for k, v in spec_tree.items()}
    return type(spec_tree)(sanitize_tree(s, a, mesh)
                           for s, a in zip(spec_tree, abstract_tree))


def placements(spec: PS, mesh) -> list:
    """One ``Shard(d)`` / ``Replicate()`` per mesh dim, in mesh order: the
    DTensor view of ``spec``.  DTensor splits a dim sharded over several
    mesh dims in mesh order, major to minor, so a tuple entry must list its
    axes in mesh order (every rule set here does) to give each rank the
    reference's shard."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for p in pos:
            out[p] = Shard(dim)
    return out


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` ready to have ``dim`` split into (``outer``, rest): a DTensor
    sharded on ``dim`` over mesh dims whose product does not divide
    ``outer`` is gathered along it first (DTensor cannot split an uneven
    shard, where the reference's compiler pads); else ``x`` unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    ways = math.prod(x.device_mesh.size(i) for i, pl in enumerate(x.placements)
                     if pl.is_shard(dim))
    if outer % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_shard(dim) else pl for pl in x.placements])


def gather_fsdp(tree, rules: AxisRules | None = None):
    """A layer's parameters gathered along the mesh axis that ``"embed"``
    maps to (FSDP / ZeRO-3: stored sharded, gathered per layer for
    compute; the backward reduce-scatters their gradients).  Other
    placements, and plain tensors, are kept."""
    from torch.distributed.tensor import DTensor, Replicate
    axis = (rules or DEFAULT_RULES).get("embed")
    axes = set(axis) if isinstance(axis, (tuple, list)) else {axis}

    def gather(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        want = [Replicate() if names[i] in axes else pl
                for i, pl in enumerate(t.placements)]
        return t if want == list(t.placements) else \
            t.redistribute(t.device_mesh, want)

    return _map(gather, tree, lambda x: not isinstance(x, (dict, list, tuple)))


def logical_placements(logical: tuple[str | None, ...], shape, mesh,
                       rules: AxisRules | None = None) -> list:
    """Placements of a tensor of ``shape`` named by ``logical`` (the spec
    sanitized against the shape)."""
    return placements(sanitize_spec(logical_spec(logical, rules, mesh),
                                    tuple(shape), mesh), mesh)


def per_shard(fn, args: tuple, in_logical: tuple, out: tuple, rules=None):
    """``fn(*args)`` on each rank's local shards, where that computes the
    same as on whole tensors (no reduction over a sharded dim): DTensor
    args are placed by their logical names (``None`` entries pass as they
    are), ``fn`` runs on the local tensors, and its result is a DTensor
    placed by ``out``, a ``(logical, global shape)`` pair.  Without a
    DTensor among ``args``, ``fn(*args)``.  The reference leaves this to
    its compiler's sharding propagation; DTensor cannot shard a batched
    matmul over two sharded batch dims."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    in_pl = tuple(None if lg is None or not isinstance(a, DTensor)
                  else logical_placements(lg, a.shape, mesh, rules)
                  for a, lg in zip(args, in_logical))
    return local_map(fn, out_placements=logical_placements(*out, mesh, rules),
                     in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def with_logical_constraint(x: torch.Tensor, logical: tuple[str | None, ...],
                            rules: AxisRules | None = None,
                            mesh=None) -> torch.Tensor:
    """Redistribute a DTensor to the logical names' placements; a plain
    tensor comes back unchanged (the reference's no-op outside a mesh).
    Mesh axes that do not divide their dim are dropped first
    (``sanitize_spec``): the reference's compiler pads an uneven shard,
    DTensor cannot split or merge one."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = mesh or x.device_mesh
    spec = sanitize_spec(logical_spec(logical, rules, mesh), tuple(x.shape),
                         mesh)
    return _Constrain.apply(x, mesh, tuple(placements(spec, mesh)))


class _Constrain(torch.autograd.Function):
    """Redistribute to ``pl``, and hold the gradient to ``pl`` too before
    it goes back to the input's placements (a partial sum there taken as
    replicated, as DTensor's own ``redistribute`` does).  The reference's
    constraint transposes to the same constraint on the cotangent; without
    it a partial-sum gradient (the input gradient of a product over a
    sharded dim) flows on down the residual stream, and the next product
    against a sharded weight gathers the weight and repeats the whole
    product on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.pl = mesh, pl
        ctx.in_pl = tuple(Replicate() if p.is_partial() else p
                          for p in x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(ctx.mesh, ctx.pl)
        return g.redistribute(ctx.mesh, ctx.in_pl), None, None
