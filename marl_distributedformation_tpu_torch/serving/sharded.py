"""Slice-backed inference: serve the big rungs over a slice of slots, not
one replica.

Counterpart of the JAX package's ``serving/sharded.py``. The fleet
(``serving/fleet/``) scales by replication: every replica holds a whole
copy of the parameters and the whole rung ladder. This module is the
other axis: one engine whose rungs run over a **slice**, a grid of slots
with named axes (``{"dp": 2}`` or ``{"dp": 2, "mp": 2}``), with

- **partition-rule placement**: ``(regex, P)`` rules map every parameter
  leaf, by its JAX path (the flax name ``compat.convert.params_from_jax``
  maps from, ``pi_0/kernel`` for ``pi_0.weight``), to a layout; one rule
  set therefore selects the same leaves in both packages. The derived
  shard functions place the parameters on the slice once: at the engine's
  build, in ``adopt_params`` and at the fleet's barrier commit, never per
  request. Rules whose axes the slice lacks, or whose dims do not divide,
  degrade to replication leaf by leaf (``fit_spec_to_mesh``).
- **batch-axis request splitting**: a padded rung of ``b`` rows splits
  into ``dp`` contiguous blocks of ``b/dp`` rows, one a **row block**.
  Each row block runs its rows as a CUDA graph (``train/capture.py::
  PhaseGraph``) captured on its own stream (``own_stream``, C6) under the
  process-wide capture lock, with its own parameter tensors, static
  buffers and generator. Events join the row blocks, and the actions land
  in one pinned buffer.
- an optional ``"mp"`` axis: a rule that splits a dense kernel over its
  OUTPUT features (``P(None, "mp")`` on the flax ``(in, out)`` kernel, its
  bias ``P("mp")``) gives the row block one parameter block an mp slot;
  the layer computes each block's output features and concatenates them,
  in JAX's feature order, on the row block's device before the next layer
  reads them, so every contraction stays whole.

**Slots and devices.** A slice is ``dp x mp`` slots; slot ``(d, j)``
holds row block ``d``'s ``j``-th parameter block, and sits on
``devices[d % len(devices)]``: the slots cycle over the given devices as
the fleet's replicas do (``router.py``), and the mp blocks of one row
block share its device, where their outputs are concatenated. On one card
``{"dp": 2}`` is two row blocks time-sharing ``cuda:0``; on the CPU, two
on ``cpu``. Parameters are replicated over ``dp``; a rule that splits a
parameter over ``dp``, a kernel over its input features, or a bias whose
kernel stays whole is refused.

The engine keeps the whole ``BucketedPolicyEngine`` contract (bucket
ladder, budget-1 ``RetraceGuard`` a rung: ``compile_counts()`` reads 1 a
rung; the program ledger counts one build a (row block, rung); one graph
serves both action modes; a swap is a copy into the captured tensors,
never a rebuild), so the fleet router treats it as one more replica that
takes the big requests. A row block's stochastic draws are the port's
own, from its generator, as the base engine's are.

**Bitwise across batch splits.** A row block of ``b/dp`` rows is the
single engine's rung of ``b/dp`` rows (same module, same GEMM shapes), so
it is bitwise equal to it; the whole rung against the single engine's
rung of ``b`` rows may differ by the GEMMs' tiling (cuBLAS may tile
M=256 and M=512 differently), and is held to serving's tolerance.
"""

from __future__ import annotations

import copy
import dataclasses
import re
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.analysis.guards import RetraceGuard
from marl_distributedformation_tpu_torch.serving.engine import (
    BucketedPolicyEngine,
    act_rows,
    inference_dtype,
)
from marl_distributedformation_tpu_torch.train.capture import (
    PhaseGraph,
    own_stream,
)


class P(tuple):
    """A partition spec: one mesh axis name (or None, whole) a dimension,
    in the JAX leaf's layout; ``P()`` is replicated. The port's own
    counterpart of ``jax.sharding.PartitionSpec`` (a tuple, as JAX's is)."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


# Default rules for this repo's actor-critic family: tower kernels may
# split over an "mp" axis on their OUTPUT features (bias splits with
# them); scalars and everything unmatched replicate. On a dp-only slice
# every rule degrades to P(): pure data parallelism.
DEFAULT_PARTITION_RULES: Tuple[Tuple[str, P], ...] = (
    ("log_std", P()),
    (r"(pi|vf)_\d+/kernel", P(None, "mp")),
    (r"(pi|vf)_\d+/bias", P("mp")),
    (r".*", P()),
)

DEFAULT_SHARDED_BUCKETS = (64, 512)


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------


class ServingSlice:
    """Named axes of serving slots over ``devices`` (see the module
    docstring): ``shape`` ``{name: size}`` and row block ``d``'s device
    ``block_device(d)``. Not ``parallel.mesh.Mesh``, which names
    processes."""

    def __init__(self, axis_sizes: Mapping[str, int],
                 devices: Sequence[Any]) -> None:
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a serving slice needs at least one device")
        sizes = {str(k): int(v) for k, v in axis_sizes.items()}
        if list(sizes.values()).count(-1) > 1:
            raise ValueError(f"at most one axis may be -1, got {sizes}")
        for name, size in sizes.items():
            if size == -1:
                known = int(np.prod([s for s in sizes.values() if s != -1]))
                sizes[name] = max(1, len(self.devices) // known)
            elif size < 1:
                raise ValueError(f"axis {name!r} has size {size}")
        self.shape: Dict[str, int] = sizes

    @property
    def dp(self) -> int:
        return self.shape.get("dp", 1)

    @property
    def mp(self) -> int:
        return self.shape.get("mp", 1)

    def block_device(self, d: int) -> torch.device:
        """The device of row block ``d`` and of its mp slots."""
        return self.devices[d % len(self.devices)]

    def __repr__(self) -> str:
        devs = sorted({str(self.block_device(d)) for d in range(self.dp)})
        return f"ServingSlice({self.shape} on {', '.join(devs)})"


def make_slice(axis_sizes: Optional[Mapping[str, int]] = None,
               devices: Optional[Sequence[Any]] = None) -> ServingSlice:
    """A serving slice of ``axis_sizes`` (default ``{"dp": -1}``: one row
    block a device) over ``devices`` (default every CUDA device; raises
    without one, the CPU only when asked for)."""
    if devices is None:
        from marl_distributedformation_tpu_torch.serving.fleet.router import (
            default_devices,
        )

        devices = default_devices()
    return ServingSlice(dict(axis_sizes or {"dp": -1}), devices)


# ---------------------------------------------------------------------------
# Partition rules
# ---------------------------------------------------------------------------


def _tree_paths(tree: Any, sep: str = "/") -> List[Tuple[str, Any]]:
    """Flatten nested mappings (and lists) into ``(joined_path, leaf)``
    pairs in ``jax.tree_util``'s order (mapping keys sorted): the name a
    partition rule matches against."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, parts: List[str]) -> None:
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(node[key], parts + [str(key)])
        elif isinstance(node, (list, tuple)) and not isinstance(node, P):
            for i, child in enumerate(node):
                walk(child, parts + [str(i)])
        else:
            out.append((sep.join(parts), node))

    walk(tree, [])
    return out


def fit_spec_to_mesh(spec: Sequence[Optional[str]], shape: Tuple[int, ...],
                     mesh: Any) -> P:
    """Degrade a spec to what ``mesh`` (anything with a ``shape`` mapping
    of axis sizes: a ``ServingSlice``) and ``shape`` support: axes the
    mesh does not have, or whose size does not divide the dim, fall back
    to ``None`` (whole on that dim). Keeps one rule set valid across every
    slice and every head width."""
    axes = []
    for i, ax in enumerate(tuple(spec)):
        ok = (
            ax is not None
            and ax in mesh.shape
            and i < len(shape)
            and shape[i] % mesh.shape[ax] == 0
        )
        axes.append(ax if ok else None)
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def _spec_for(rules: Sequence[Tuple[str, Sequence[Optional[str]]]],
              name: str, shape: Tuple[int, ...], mesh: Any) -> P:
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return P()
    for pattern, spec in rules:
        if re.search(pattern, name) is not None:
            return fit_spec_to_mesh(spec, shape, mesh)
    raise ValueError(f"no partition rule matched param {name!r}")


def match_partition_rules(rules: Sequence[Tuple[str, Any]], params: Any,
                          mesh: Any) -> Any:
    """Tree of ``P`` from ``(regex, spec)`` rules, matched against each
    leaf's ``/``-joined path (first match wins). Scalars never partition;
    matched specs are fitted to the mesh (:func:`fit_spec_to_mesh`).
    ``params`` is a tree of nested mappings (the JAX package's layout);
    the result has its structure. Raises when no rule matches a leaf:
    ship a catch-all as the last rule."""

    named = {name: _spec_for(rules, name, tuple(np.shape(leaf)), mesh)
             for name, leaf in _tree_paths(params)}

    def build(node: Any, parts: List[str]) -> Any:
        if isinstance(node, Mapping):
            return {k: build(v, parts + [str(k)]) for k, v in node.items()}
        return named["/".join(parts)]

    return build(params, [])


def jax_path(name: str) -> str:
    """The JAX path of a ``state_dict`` name: ``actor.pi_0.weight`` ->
    ``actor/pi_0/kernel`` (``compat.convert``'s mapping)."""
    *path, leaf = name.split(".")
    return "/".join(path + ["kernel" if leaf == "weight" else leaf])


def _is_kernel(name: str, ndim: int) -> bool:
    return name.rsplit(".", 1)[-1] == "weight" and ndim >= 2


def _jax_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A leaf's shape in the JAX layout: a dense kernel is ``(in, out)``
    where the torch weight is ``(out, in)``."""
    if _is_kernel(name, len(shape)):
        return (*shape[:-2], shape[-1], shape[-2])
    return tuple(shape)


def _torch_dim(name: str, ndim: int, jax_dim: int) -> int:
    """The torch dim of a JAX-layout dim of leaf ``name``."""
    if _is_kernel(name, ndim) and jax_dim >= ndim - 2:
        return 2 * ndim - 3 - jax_dim
    return jax_dim


def param_specs_of(rules: Sequence[Tuple[str, Any]],
                   params: Mapping[str, torch.Tensor],
                   mesh: Any) -> Dict[str, P]:
    """``{state_dict name: P}`` for a torch ``state_dict``: each leaf
    matched by its JAX path and fitted at its JAX-layout shape, so the
    specs are JAX's ``param_specs`` leaf for leaf."""
    return {
        name: _spec_for(rules, jax_path(name),
                        _jax_shape(name, tuple(t.shape)), mesh)
        for name, t in params.items()
    }


def _split_dim(name: str, ndim: int, spec: P) -> Optional[int]:
    """The torch dim ``spec`` splits over "mp" (None when whole); refuses
    what the port's slice does not place (module docstring)."""
    if "dp" in spec:
        raise ValueError(
            f"param {name!r} has spec {spec}: the port's serving slice "
            "replicates parameters over 'dp' (it splits requests there)"
        )
    dims = [i for i, ax in enumerate(spec) if ax == "mp"]
    if not dims:
        return None
    if len(dims) > 1:
        raise ValueError(f"param {name!r} splits two dims over 'mp': {spec}")
    return _torch_dim(name, ndim, dims[0])


def _place_leaf(name: str, spec: P, leaf: torch.Tensor, mesh: ServingSlice,
                d: int) -> Tuple[torch.Tensor, ...]:
    """Row block ``d``'s copies of ``leaf``: one whole, or its ``mp``
    blocks, contiguous on the row block's device."""
    leaf = leaf.detach()
    dim = _split_dim(name, leaf.dim(), spec)
    parts = (leaf,) if dim is None else leaf.chunk(mesh.mp, dim=dim)
    return tuple(p.to(mesh.block_device(d), copy=True,
                      memory_format=torch.contiguous_format)
                 for p in parts)


def make_shard_and_gather_fns(
    specs: Mapping[str, Sequence[Optional[str]]], mesh: ServingSlice,
) -> Tuple[Dict[str, Callable], Dict[str, Callable]]:
    """Per-leaf shard and gather callables from ``{name: spec}``.

    ``shard_fn(leaf)`` returns, for each row block ``d`` of the slice, the
    tensors its slots hold of the leaf on the row block's device: one
    whole copy, or the ``mp`` blocks of a split leaf. Called once a
    placement event (engine build, ``adopt_params``, the barrier commit),
    never on the request path. ``gather_fn(placed)`` brings a placed leaf
    back to one host tensor (row block 0's blocks concatenated)."""

    def _make(name: str, spec: Sequence[Optional[str]]):
        spec = P(*spec)

        def shard_fn(leaf: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
            return tuple(_place_leaf(name, spec, leaf, mesh, d)
                         for d in range(mesh.dp))

        def gather_fn(placed: Sequence[Sequence[torch.Tensor]]
                      ) -> torch.Tensor:
            blocks = [t.detach().cpu() for t in placed[0]]
            if len(blocks) == 1:
                return blocks[0].clone()
            return torch.cat(blocks, dim=_split_dim(name, blocks[0].dim(),
                                                    spec))

        return shard_fn, gather_fn

    pairs = {name: _make(name, spec) for name, spec in specs.items()}
    return ({n: p[0] for n, p in pairs.items()},
            {n: p[1] for n, p in pairs.items()})


# ---------------------------------------------------------------------------
# The spec a fleet builds its slice from
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedSpec:
    """How a fleet builds its slice-backed big-rung engine.

    ``axis_sizes`` follows ``make_slice`` (``{"dp": -1}``, the default
    when None: one row block a fleet device). ``min_rows`` is the routing
    threshold: requests with at least this many rows prefer the sharded
    engine; smaller ones stay on the replicas. ``dtype`` opts the sharded
    rungs into bf16. ``window_ms`` is the slice's own coalescing window
    (``None`` inherits the fleet's): a dedicated lane whose routing floor
    fills its smallest rung has nothing to coalesce, so the autotuner
    emits 0.0 there (``LadderPlan.sharded_window_ms``)."""

    axis_sizes: Optional[Dict[str, int]] = None
    buckets: Tuple[int, ...] = DEFAULT_SHARDED_BUCKETS
    min_rows: Optional[int] = None
    dtype: Optional[str] = None
    rules: Tuple[Tuple[str, P], ...] = DEFAULT_PARTITION_RULES
    window_ms: Optional[float] = None

    @property
    def route_min_rows(self) -> int:
        return self.min_rows if self.min_rows else min(self.buckets)

    def evolved(self, **changes: object) -> "ShardedSpec":
        """A new spec with ``changes`` applied: the delta form the elastic
        controller hands the fleet when it re-derives part of the slice
        (new ``buckets`` from a retune while the axes stay). Unknown
        fields raise, as ``dataclasses.replace`` does."""
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class _BlockLinear(torch.nn.Module):
    """A dense layer held as its mp slots' blocks of output features: each
    block's output computed, then concatenated in feature order (JAX's)."""

    def __init__(self, layer: torch.nn.Linear, mp: int,
                 split_bias: bool) -> None:
        super().__init__()
        has_bias = layer.bias is not None
        self.blocks = torch.nn.ModuleList()
        for w, j in zip(layer.weight.detach().chunk(mp, dim=0), range(mp)):
            blk = torch.nn.Linear(w.shape[1], w.shape[0],
                                  bias=has_bias and split_bias,
                                  device=w.device)
            blk.weight.data.copy_(w)
            if has_bias and split_bias:
                blk.bias.data.copy_(layer.bias.detach().chunk(mp)[j])
            self.blocks.append(blk)
        self.bias = (torch.nn.Parameter(layer.bias.detach().clone())
                     if has_bias and not split_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([blk(x) for blk in self.blocks], dim=-1)
        return y if self.bias is None else y + self.bias


class _RowBlock:
    """Row block ``d`` of a slice: its module (split layers as
    ``_BlockLinear``), the parameter tensors its graphs read, its
    generator, mode flag and stream, and its rungs."""

    def __init__(self, engine: "ShardedPolicyEngine", d: int) -> None:
        self.index = d
        self.device = engine.mesh.block_device(d)
        model = copy.deepcopy(engine.policy.model).to(self.device)
        for module_name, split_bias in engine._split_layers.items():
            parent_name, _, leaf = module_name.rpartition(".")
            parent = model.get_submodule(parent_name)
            setattr(parent, leaf, _BlockLinear(
                getattr(parent, leaf), engine.mesh.mp, split_bias))
        self.model = model.eval().requires_grad_(False)
        self.params = self.model.state_dict()
        self.generator = torch.Generator(device=self.device).manual_seed(
            engine._seed + d)
        self.det = torch.ones((), dtype=torch.bool, device=self.device)
        self.stream = own_stream(self, self.device)
        self.rungs: Dict[int, "_BlockRung"] = {}


class _BlockRung:
    """One row block's part of one rung: a static input of ``b/dp`` rows
    and the act that reads it, captured on the row block's stream (or
    eager); ``out`` holds the actions the last run wrote."""

    def __init__(self, engine: "ShardedPolicyEngine", block: _RowBlock,
                 bucket: int, row_shape: Tuple[int, ...]) -> None:
        rows = bucket // engine.mesh.dp
        self.x = torch.zeros((rows, *row_shape), device=block.device)
        self.out: Optional[torch.Tensor] = None

        def act() -> None:
            self.out = act_rows(block.model, block.params, engine.dtype,
                                block.generator, block.det, self.x)

        self.graph = PhaseGraph(
            f"serving-sharded-act-bucket{bucket}-block{block.index}", act,
            generators=[block.generator], capture=engine.capture,
            guard=(engine.block_guards[(bucket, block.index)]
                   if engine.capture else None),
            signature=(self.x,),
            subsystem="serving_sharded",
            program=f"act_rung{bucket}_block{block.index}_"
                    f"{engine.dtype_label}",
            stream=block.stream,
        )


class PlacedParams:
    """A parameter tree placed on a slice: for each row block, its
    ``state_dict`` names (split leaves as their ``blocks.{j}`` names) to
    tensors on its device. What a sharded replica's registry cell holds
    and the engine copies into its captured tensors."""

    def __init__(self, blocks: List[Dict[str, torch.Tensor]]) -> None:
        self.blocks = blocks


class ShardedPolicyEngine(BucketedPolicyEngine):
    """``BucketedPolicyEngine`` whose rungs run over a slice; see the
    module docstring.

    Args:
      policy: a ``compat.policy.LoadedPolicy``.
      mesh: the ``ServingSlice`` (``make_slice``), which needs a ``dp``
        axis; every bucket must divide by its size.
      buckets, max_traces_per_bucket, seed, dtype, capture: as the base
        engine's (``seed + d`` seeds row block ``d``'s generator).
      rules: ``(regex, P)`` partition rules over the JAX paths.
    """

    is_sharded = True

    def __init__(
        self,
        policy: Any,
        mesh: ServingSlice,
        buckets: Tuple[int, ...] = DEFAULT_SHARDED_BUCKETS,
        rules: Sequence[Tuple[str, Any]] = DEFAULT_PARTITION_RULES,
        max_traces_per_bucket: Optional[int] = 1,
        seed: int = 0,
        dtype: Optional[str] = None,
        capture: bool = True,
    ) -> None:
        if "dp" not in mesh.shape:
            raise ValueError(
                f"sharded serving needs a 'dp' mesh axis for the request "
                f"batch; mesh has {dict(mesh.shape)}"
            )
        dp = mesh.shape["dp"]
        bad = [b for b in buckets if b % dp != 0]
        if bad:
            raise ValueError(
                f"sharded buckets must divide by dp={dp}; {bad} do not "
                "(rows split evenly across the mesh slice)"
            )
        self.policy = policy
        self.mesh = mesh
        self.rules = tuple(rules)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.dtype = inference_dtype(dtype)
        self._seed = int(seed)
        self.param_specs = param_specs_of(self.rules, policy.params, mesh)
        self._split_layers = self._check_splits(policy.model)
        _, self._gather_fns = make_shard_and_gather_fns(self.param_specs,
                                                        mesh)
        # compile_counts() reads the rung guards (1 a rung, the whole
        # slice built); each row block's capture counts on its own.
        self.guards: Dict[int, RetraceGuard] = {
            b: RetraceGuard(f"serving-sharded-act-bucket{b}",
                            max_traces=max_traces_per_bucket)
            for b in self.buckets
        }
        self.block_guards: Dict[Tuple[int, int], RetraceGuard] = {
            (b, d): RetraceGuard(
                f"serving-sharded-act-bucket{b}-block{d}",
                max_traces=max_traces_per_bucket)
            for b in self.buckets for d in range(dp)
        }
        self.row_blocks = [_RowBlock(self, d) for d in range(dp)]
        self.device = self.row_blocks[0].device
        self.capture = bool(capture) and all(
            b.device.type == "cuda" for b in self.row_blocks)
        # The standalone default for nn_params=None, placed once, now.
        self._own: PlacedParams = self.shard_params(policy.params)
        self._loaded: Any = None
        self._stage_in: Optional[torch.Tensor] = None
        self._stage_out: Optional[torch.Tensor] = None
        self._lock = threading.Lock()
        self._row_shape: Optional[Tuple[int, ...]] = None

    def _check_splits(self, model: torch.nn.Module) -> Dict[str, bool]:
        """``{module name: bias split}`` of the dense layers the specs
        split over their output features; refuses every other split."""
        modules = dict(model.named_modules())
        split: Dict[str, bool] = {}
        biases = set()
        for name, spec in self.param_specs.items():
            dim = _split_dim(name, self.policy.params[name].dim(), spec)
            if dim is None:
                continue
            module_name, _, leaf = name.rpartition(".")
            layer = modules.get(module_name)
            if not isinstance(layer, torch.nn.Linear) or dim != 0 \
                    or leaf not in ("weight", "bias"):
                raise ValueError(
                    f"param {name!r} has spec {spec}: the port's slice "
                    "splits a dense kernel over its output features only"
                )
            if leaf == "weight":
                split.setdefault(module_name, False)
            else:
                biases.add(module_name)
        orphan = biases - set(split)
        if orphan:
            raise ValueError(
                f"biases {sorted(orphan)} split over 'mp' while their "
                "kernels stay whole"
            )
        return {m: m in biases for m in split}

    # -- placement (the once-per-event path) -----------------------------

    def shard_params(self, params: Mapping[str, torch.Tensor]
                     ) -> PlacedParams:
        """Place a ``state_dict`` (any device) on the slice under the
        partition rules: the only placement path, called at the engine's
        build, in ``adopt_params`` and at the reload commit
        (``fleet.reload.device_copy`` calls it for a sharded replica's
        registry cell), never per request. The copies are finished when
        this returns."""
        if set(params) != set(self.param_specs):
            raise ValueError(
                f"parameter names {sorted(params)} differ from the served "
                f"model's {sorted(self.param_specs)}")
        blocks: List[Dict[str, torch.Tensor]] = []
        for d, row_block in enumerate(self.row_blocks):
            # Each row block's copies on a side stream of its device,
            # finished before this returns (``fleet.reload.device_copy``'s
            # way: no device-wide synchronize while others capture).
            side = None
            if row_block.device.type == "cuda":
                side = torch.cuda.Stream(row_block.device)
                side.wait_stream(torch.cuda.current_stream(row_block.device))
            block: Dict[str, torch.Tensor] = {}
            with torch.cuda.stream(side):
                for name, leaf in params.items():
                    parts = _place_leaf(name, self.param_specs[name], leaf,
                                        self.mesh, d)
                    if len(parts) == 1:
                        block[name] = parts[0]
                        continue
                    prefix, _, leaf_name = name.rpartition(".")
                    for j, part in enumerate(parts):
                        block[f"{prefix}.blocks.{j}.{leaf_name}"] = part
            if side is not None:
                side.synchronize()
            if set(block) != set(row_block.params):
                raise AssertionError(
                    f"row block {d}: placed {sorted(block)}, serves "
                    f"{sorted(row_block.params)}")
            blocks.append(block)
        return PlacedParams(blocks)

    def gather_params(self, placed: PlacedParams
                      ) -> Dict[str, torch.Tensor]:
        """A placed tree back to one host ``state_dict``."""
        out = {}
        block = placed.blocks[0]
        for name in self.param_specs:
            prefix, _, leaf = name.rpartition(".")
            if name in block:
                parts = [block[name]]
            else:
                parts = [block[f"{prefix}.blocks.{j}.{leaf}"]
                         for j in range(self.mesh.mp)]
            out[name] = self._gather_fns[name]([parts])
        return out

    def adopt_params(self, params: Mapping[str, torch.Tensor]
                     ) -> PlacedParams:
        """Replace the engine's resident tree with ``params`` placed on
        the slice, and return it: the elastic prewarm path puts the
        CURRENT fleet parameters on a fresh slice so, replacing the boot
        copy of the wrapped policy's."""
        self._own = self.shard_params(params)
        return self._own

    # -- dispatch ---------------------------------------------------------

    def rung(self, bucket: int) -> Optional[List[_BlockRung]]:
        """The row blocks' parts of ``bucket``'s rung, or None before its
        first dispatch."""
        if bucket not in self.row_blocks[0].rungs:
            return None
        return [b.rungs[bucket] for b in self.row_blocks]

    def _load_block(self, block: _RowBlock, placed: PlacedParams) -> None:
        src = placed.blocks[block.index]
        for name, dst in block.params.items():
            dst.copy_(src[name], non_blocking=True)

    def _build_rung(self, bucket: int, row_shape: Tuple[int, ...],
                    stage: torch.Tensor) -> None:
        """Build ``bucket``'s rung on every row block, ``stage`` its
        padded rows: on the card each row block's warm-up, then its
        capture (its guard counts it) and replay; on the CPU the eager
        build. The rung's guard counts the whole slice's build once."""
        h = bucket // self.mesh.dp
        parts = [_BlockRung(self, b, bucket, row_shape)
                 for b in self.row_blocks]

        def build() -> None:
            for block, part in zip(self.row_blocks, parts):
                with torch.cuda.stream(block.stream):
                    part.x.copy_(stage[block.index * h:(block.index + 1) * h])
                    part.graph()
                    if self.capture:
                        part.graph()

        if self.capture:
            build()
            self.guards[bucket].record(parts[0].x)
        else:
            self.guards[bucket].wrap(build)()
        for block, part in zip(self.row_blocks, parts):
            block.rungs[bucket] = part

    def act(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        nn_params: Optional[PlacedParams] = None,
    ) -> np.ndarray:
        """Actions for ``obs`` rows: padded to the rungs of ``plan(n)``,
        each rung's rows split into ``dp`` row blocks that run on their
        own streams, joined, the padding sliced back off. ``nn_params``
        is a tree placed on this slice (``shard_params``; the registry
        cell's); None serves the engine's own."""
        obs, row_shape = self._rows(obs)
        chunks = self.plan(obs.shape[0])
        placed = self._own if nn_params is None else nn_params
        if not isinstance(placed, PlacedParams) or \
                len(placed.blocks) != self.mesh.dp:
            raise ValueError(
                "the sharded engine serves parameters placed on its slice "
                "(engine.shard_params, the registry cell's); got "
                f"{type(placed).__name__}")
        h_of = {b: b // self.mesh.dp for b in set(chunks)}
        with self._lock, torch.no_grad():
            stage, offsets = self._stage(obs, chunks)
            out: Optional[torch.Tensor] = None
            streams = [b.stream for b in self.row_blocks]
            try:
                for block in self.row_blocks:
                    if block.stream is not None:
                        block.stream.wait_stream(
                            torch.cuda.current_stream(block.device))
                    with torch.cuda.stream(block.stream):
                        if placed is not self._loaded:
                            self._load_block(block, placed)
                        block.det.fill_(bool(deterministic))
                self._loaded = placed
                for bucket, (off, _) in zip(chunks, offsets):
                    h = h_of[bucket]
                    if bucket not in self.row_blocks[0].rungs:
                        self._build_rung(bucket, row_shape,
                                         stage[off:off + bucket])
                        fresh = True
                    else:
                        fresh = False
                    for block in self.row_blocks:
                        part = block.rungs[bucket]
                        lo = off + block.index * h
                        with torch.cuda.stream(block.stream):
                            if not fresh:
                                part.x.copy_(stage[lo:lo + h],
                                             non_blocking=True)
                                part.graph()
                            if out is None:
                                out = self._staging(
                                    "_stage_out", sum(chunks),
                                    tuple(part.out.shape[1:]))
                            out[lo:lo + h].copy_(part.out,
                                                 non_blocking=True)
            finally:
                # The row blocks join here: one event a stream, every
                # chunk enqueued; also when a chunk raised, so no copy is
                # left in flight from the staging buffers.
                events = []
                for s in streams:
                    if s is not None:
                        ev = torch.cuda.Event()
                        ev.record(s)
                        events.append(ev)
                for ev in events:
                    ev.synchronize()
            self._row_shape = row_shape
            actions = out.numpy()
            return np.concatenate([actions[o:o + k] for o, k in offsets])
