"""Device meshes over `torch.distributed`, the counterpart of
`cvaegan_tpu/parallel/mesh.py`.

JAX shards arrays over a ('data', 'model') mesh and lets GSPMD insert the
collectives. Here each rank is one process with one device, every rank
runs the same program on its own rows, and the collectives are written
out:

  * a `Mesh` is PyTorch's own `DeviceMesh` over ('data', 'model'), one
    device per rank; `use_mesh` activates one process-wide, as in JAX;
  * `shard_leading(x)` keeps this data rank's rows of a global batch.
    Every rank draws the same global batch from a generator in the same
    state and keeps its slice, so the math is the single-process global
    batch's. Shards are ceil-sized, as GSPMD's are, and a rank that would
    get no rows raises (JAX pads it);
  * inside `data_parallel(rows)`, which a trainer enters around its
    epochs under a mesh: train-mode BatchNorm takes its moments over the
    global batch (`all_reduce`, differentiable: SUM forward, SUM
    backward); the per-row draws that the JAX package leaves to GSPMD
    (dropout masks, reparameterisation noise, CTGAN's column masks and
    interpolation alpha, QG-SMOTE's alpha) are drawn for the global batch
    and sliced (`local_draw`, `local_rows`); and `core.state.grad_update`
    weighs each rank's local-mean loss by the rank's share of the batch
    and sums the gradients, and the loss values, over the data axis in one
    flat all-reduce (`reduce_flat`). Collectives run at every group size,
    1 included;
  * the 'model' axis (tensor parallelism): `shard_net_state` gives the
    JAX package's per-leaf specs, and `place` leaves on each rank the
    contiguous block of every 'model'-sharded leaf at its 'model'
    coordinate (and the same block of its Adam moments), marked with a
    `ModelShard` that the layers read (`models/layers.py`). The math is
    the single-process math: every value the layers pass on is whole on
    every model rank, and the loss is computed alike on each. Megatron's
    conjugate pairs, each twice differentiable (CTGAN's gradient penalty
    differentiates through them twice), carry a value between whole
    ("R") and sliced ("S") forms over the model group:
      - `gather_model` (S -> R): all-gather forward; its backward keeps
        the rank's own slice of the (whole) gradient (`split_model`);
      - `split_model` (R -> S): the rank's slice forward; all-gather
        backward;
      - `enter_model` (R -> R, before a sliced computation reads a whole
        value): identity forward; SUM all-reduce backward (`model_sum`),
        since each rank's gradient holds only its slice's part;
      - `model_sum` (partial -> R): SUM all-reduce forward; identity
        backward.
    Gradients of replicated leaves are computed alike on every model rank
    and are never summed over 'model'; `core.state` sums every gradient
    over the 'data' group only, which under a 2-D mesh holds the ranks of
    one model coordinate, so slices sum with their peers.

`COLLECTIVES` counts the collectives this module has issued.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")

#: collectives issued through this module since the count was last set to 0
COLLECTIVES = 0

_ACTIVE_MESH: Optional["Mesh"] = None
_ROWS: Optional["RowLayout"] = None


class Mesh:
    """A ('data', 'model') grid of ranks, one device each, backed by
    `torch.distributed.device_mesh.DeviceMesh`."""

    axis_names = AXES

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as JAX's `mesh.shape`."""
        return {name: self.device_mesh.size(i) for i, name in enumerate(AXES)}

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self.device_mesh.get_group(axis)

    def local_rank(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(n_data: int, n_model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A ('data', 'model') mesh of the first `n_data * n_model` ranks of
    `devices` (global ranks of the process group, all of them by
    default). Every rank of the group must call it, as for any new
    process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    ranks = list(range(dist.get_world_size()) if devices is None else devices)
    need = n_data * n_model
    if len(ranks) < need:
        raise ValueError(f"mesh needs {need} devices, found {len(ranks)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if devices is None:
        return Mesh(init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES))
    grid = torch.tensor(ranks[:need]).reshape(n_data, n_model)
    return Mesh(DeviceMesh(device_type, grid, mesh_dim_names=AXES))


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Activate a mesh for the duration of a block, process-wide: the
    trainers' draws and steps pick it up. `None` runs the block without
    one."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def shard_bounds(rows: int, mesh: Mesh) -> tuple:
    """[lo, hi) of this data rank's rows of `rows`, in ceil-sized shards.
    Raises on every rank where the last would get none (JAX would pad its
    shard), so that no rank goes on to a collective alone."""
    n = mesh.shape["data"]
    size = -(-rows // n)
    if (n - 1) * size >= rows:
        raise ValueError(f"a batch of {rows} rows in shards of {size} leaves data rank "
                         f"{n - 1} of {n} without rows: use a batch of more rows")
    lo = mesh.local_rank("data") * size
    return lo, min(lo + size, rows)


def shard_leading(x: torch.Tensor) -> torch.Tensor:
    """This data rank's rows of the global batch `x` (its leading axis)
    when a mesh is active; `x` itself otherwise. The port's counterpart
    of the JAX package's sharding annotation, called at the same sites."""
    return local_rows(x)


def local_rows(x: torch.Tensor, segments: int = 1) -> torch.Tensor:
    """This data rank's rows of `x`, whose leading axis holds `segments`
    global batches one after another (e.g. a draw for concat(real, fake)):
    the rank's rows of each, concatenated, as its local tensors are; `x`
    itself without an active mesh. The port slices so where the JAX
    package leaves a per-row draw to GSPMD."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    rows = x.shape[0] // segments
    if rows * segments != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows are not {segments} batches")
    lo, hi = shard_bounds(rows, mesh)
    if segments == 1:
        return x[lo:hi]
    return torch.cat([x[s * rows + lo:s * rows + hi] for s in range(segments)])


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """The rows of one global batch and this data rank's share of them."""

    mesh: Mesh
    rows: int
    lo: int
    hi: int

    @property
    def weight(self) -> float:
        """This rank's share of the batch: a local mean times it, summed
        over the data axis, is the global mean."""
        return (self.hi - self.lo) / self.rows

    @property
    def group(self):
        return self.mesh.group("data")


@contextlib.contextmanager
def data_parallel(rows: int):
    """Inside the block, under the active mesh, the train steps treat
    their batches as this data rank's rows of global batches of `rows`
    (BatchNorm moments, per-row draws, gradient sums; see the module
    docstring). Without an active mesh it does nothing."""
    global _ROWS
    mesh = _ACTIVE_MESH
    prev = _ROWS
    if mesh is not None:
        _ROWS = RowLayout(mesh, rows, *shard_bounds(rows, mesh))
    try:
        yield _ROWS
    finally:
        _ROWS = prev


def batch_layout() -> Optional[RowLayout]:
    """The layout of `data_parallel` in force, or None."""
    return _ROWS


def local_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` for a tensor of this rank's rows: inside
    `data_parallel` the draw is made for the global batches its leading
    axis holds (whole multiples of the rank's share) and sliced, so that
    every rank's generator advances as the single-process one does and
    each row gets the single-process row's values."""
    layout = _ROWS
    if layout is None:
        return draw(tuple(shape))
    share = layout.hi - layout.lo
    segments = shape[0] // share
    if segments * share != shape[0]:
        raise ValueError(f"{shape[0]} rows are not a multiple of the rank's {share}")
    return local_rows(draw((segments * layout.rows, *shape[1:])), segments)


# ---------------------------------------------------------------------------
# Collectives
def _all_reduce(x: torch.Tensor, group) -> None:
    global COLLECTIVES
    COLLECTIVES += 1
    dist.all_reduce(x, group=group)


class _AllReduce(torch.autograd.Function):
    """SUM over `group` forward; the backward is the SUM all-reduce of the
    upstream gradients (itself differentiable, for a double backward), so
    each rank's input gets the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad.contiguous(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM all-reduce of `x` over `group` (a new tensor)."""
    return _AllReduce.apply(x, group)


@torch.no_grad()
def reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """SUM all-reduce of float32 `tensors` over `group` in one collective
    on one flat buffer; returns the sums in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group)
    return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]),
                                            tensors)]


def _device(mesh: Mesh) -> torch.device:
    """This rank's device of `mesh`, which its collectives run on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


@torch.no_grad()
def broadcast(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Copy the first rank's `tensors` to every rank of the mesh, in place:
    a replicated tensor from coordinate 0 on both axes, a tensor `place`
    left sliced over 'model' (`ModelShard`) from data coordinate 0 of the
    rank's own model coordinate, so each keeps its slice. One flat
    broadcast per dtype, kind and axis. Tensors on the CPU travel through
    the mesh's device."""
    global COLLECTIVES
    for t in tensors:
        shard = shard_of(t)
        if shard is not None and shard.mesh is not mesh:
            raise ValueError(f"a tensor placed on {shard.mesh} is broadcast over {mesh}: "
                             "place the state on the mesh it runs on")
    kinds = {}
    for i, t in enumerate(tensors):
        kinds.setdefault((t.dtype, shard_of(t) is None), []).append(i)
    for (_, whole), idx in kinds.items():
        flat = torch.cat([tensors[i].reshape(-1).to(_device(mesh)) for i in idx])
        for axis in AXES if whole else ("data",):
            group = mesh.group(axis)
            COLLECTIVES += 1
            dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view(tensors[i].shape))


@torch.no_grad()
def all_gather_items(items: Sequence[Sequence[torch.Tensor]],
                     mesh: Mesh) -> List[List[torch.Tensor]]:
    """Every data rank's `items` (lists of tensors of one structure: the
    same shapes and dtypes in each item, on every rank), in data-rank
    order, on every rank: one all-gather over the 'data' axis per dtype.
    The results lie on the mesh's device."""
    global COLLECTIVES
    group, n = mesh.group("data"), mesh.shape["data"]
    template = items[0]
    out = [[None] * len(template) for _ in range(n * len(items))]
    for idx in _by_dtype(template).values():
        flat = torch.cat([item[j].reshape(-1).to(_device(mesh)) for item in items for j in idx])
        bufs = [torch.empty_like(flat) for _ in range(n)]
        COLLECTIVES += 1
        dist.all_gather(bufs, flat, group=group)
        for r, buf in enumerate(bufs):
            parts = iter(buf.split([template[j].numel() for j in idx] * len(items)))
            for i in range(len(items)):
                for j in idx:
                    out[r * len(items) + i][j] = next(parts).view(template[j].shape)
    return out


def broadcast_generator(generator: torch.Generator, mesh: Mesh) -> None:
    """Give every rank the first rank's generator state."""
    state = generator.get_state()
    broadcast([state], mesh)
    generator.set_state(state)


# ---------------------------------------------------------------------------
# The 'model' axis: placement and its collectives
@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Where `place` left a leaf: this rank holds the contiguous block of
    the whole leaf along `dim` at its 'model' coordinate of `mesh` (the
    whole leaf on a 'model' axis of size 1)."""

    mesh: Mesh
    dim: int

    @property
    def n(self) -> int:
        return self.mesh.shape["model"]

    @property
    def index(self) -> int:
        return self.mesh.local_rank("model")

    @property
    def group(self):
        return self.mesh.group("model")


#: the attribute of a placed tensor that holds its `ModelShard`
_SHARD_ATTR = "model_shard"


def shard_of(t: Optional[torch.Tensor]) -> Optional[ModelShard]:
    """The `ModelShard` `place` left on `t`, or None (replicated, unplaced,
    or no tensor)."""
    return getattr(t, _SHARD_ATTR, None)


def _gather(x: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    """All-gather of every model rank's block of `x` along `dim`, in rank
    order: the whole tensor (a new one, contiguous)."""
    global COLLECTIVES
    x = x.contiguous()
    out = x.new_empty((shard.n * x.shape[0], *x.shape[1:]))
    COLLECTIVES += 1
    dist.all_gather_into_tensor(out, x, group=shard.group)
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= shard.n
    return out.view(shard.n, *x.shape).movedim(0, dim).reshape(shape)


def local_part(x: torch.Tensor, shard: Optional[ModelShard], dim: Optional[int] = None
               ) -> torch.Tensor:
    """This rank's block of the whole tensor `x` along `dim` (the shard's
    by default), as `place` slices a leaf; `x` itself for no shard."""
    if shard is None:
        return x
    dim = shard.dim if dim is None else dim
    size = x.shape[dim] // shard.n
    if size * shard.n != x.shape[dim]:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not divide into "
                         f"{shard.n} 'model' slices")
    return x.narrow(dim, shard.index * size, size)


class _GatherModel(torch.autograd.Function):
    """S -> R along the last axis: all-gather forward, the rank's slice of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather(x, x.dim() - 1, shard)

    @staticmethod
    def backward(ctx, grad):
        return _SplitModel.apply(grad, ctx.shard), None


class _SplitModel(torch.autograd.Function):
    """R -> S along the last axis: the rank's slice forward, all-gather
    backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return local_part(x, shard, x.dim() - 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherModel.apply(grad, ctx.shard), None


class _EnterModel(torch.autograd.Function):
    """Identity forward; SUM all-reduce over 'model' backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ModelSum.apply(grad, ctx.shard), None


class _ModelSum(torch.autograd.Function):
    """SUM all-reduce over 'model' forward; identity backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        y = x.clone()
        _all_reduce(y, shard.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _EnterModel.apply(grad, ctx.shard), None


def gather_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """The whole of `x` from every model rank's slice of its last axis
    (differentiable); `x` itself for no shard."""
    return x if shard is None else _GatherModel.apply(x, shard)


def split_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """This model rank's slice of the last axis of the whole `x`
    (differentiable); `x` itself for no shard."""
    return x if shard is None else _SplitModel.apply(x, shard)


def enter_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """`x`, whole on every model rank, as the input of a sliced computation:
    its gradient is summed over 'model' (differentiable); `x` itself for
    no shard."""
    return x if shard is None else _EnterModel.apply(x, shard)


def model_sum(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """SUM of every model rank's partial `x` (differentiable); `x` itself
    for no shard."""
    return x if shard is None else _ModelSum.apply(x, shard)


def whole(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A 1-D leaf whole: gathered over 'model' (differentiable) where
    `place` sliced it, else itself (None for None)."""
    return gather_model(t, shard_of(t)) if t is not None else None


@torch.no_grad()
def gather_leaf(t: torch.Tensor) -> torch.Tensor:
    """The whole leaf from the slices of every model rank (a new tensor,
    without gradient); `t` itself where it is not sliced. Every rank of
    the leaf's model group calls it."""
    shard = shard_of(t)
    return t if shard is None else _gather(t.detach(), shard.dim, shard)


def _whole_shape(t: torch.Tensor) -> List[int]:
    """The shape of the whole leaf of which `t` may be a slice."""
    shape, shard = list(t.shape), shard_of(t)
    if shard is not None:
        shape[shard.dim] *= shard.n
    return shape


def placement_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """What a captured graph or a cache of `tensors` depends on beyond
    their values: each tensor's storage, shape and `ModelShard`. `place`
    changes all three."""
    return tuple((t.data_ptr(), tuple(t.shape), shard_of(t)) for t in tensors)


# ---------------------------------------------------------------------------
# Specs ('model' axis)
class P(tuple):
    """A partition spec, as JAX's `PartitionSpec`: per leading axis of a
    leaf, the mesh axis it is sharded over or None; `P()` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: P


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _leaf_spec(shape, n_model: int) -> P:
    """Tensor-parallel spec of one leaf in the JAX package's layout: the
    output/feature dim over 'model' when it divides evenly, else
    replicated. Dense kernels `[in, out]` -> P(None, 'model'); 1-D
    scales and biases `[out]` -> P('model')."""
    if n_model <= 1:
        return P()
    if len(shape) == 2 and shape[1] % n_model == 0:
        return P(None, "model")
    if len(shape) == 1 and shape[0] % n_model == 0 and shape[0] >= n_model:
        return P("model")
    return P()


def _networks(state: nn.Module):
    """(name, network, stack) of a trainer state: its networks (stack
    None), and each generator of a list of them (TMG-GAN's `gens`) as
    `name.i`, with stack the list's length: the JAX package stacks such a
    list's leaves on a leading axis of that length."""
    for name, net in state.items() if isinstance(state, nn.ModuleDict) else [("", state)]:
        if isinstance(net, (nn.ModuleList, nn.ModuleDict)):
            members = list(net.values() if isinstance(net, nn.ModuleDict) else net)
            for i, sub in enumerate(members):
                yield f"{name}.{i}", sub, len(members)
        else:
            yield name, net, None


def shard_net_state(state, mesh: Mesh, n_model: Optional[int] = None):
    """Per-leaf shardings of a state: for a mapping of arrays or tensors,
    the same mapping of `NamedSharding`s by `_leaf_spec` of each leaf's
    shape, as the JAX package's; for a trainer's `nn.ModuleDict`, `{network:
    {Flax path: NamedSharding}}` with each spec taken on the leaf's shape in
    the Flax layout (`convert.net_leaves`: a Dense weight `[out, in]` is
    the kernel `[in, out]`), so the specs equal the JAX package's for the
    same weights. A generator of TMG-GAN's list `gens` (JAX stacks them)
    takes the spec of its leaf's stacked shape `[L, *shape]` without the
    leading axis: its Dense kernels `[L, in, out]` are replicated, its
    biases and BatchNorm leaves `[L, out]` sharded on their feature axis.
    An Adam moment mirrors its parameter's spec. `n_model` takes the specs
    a 'model' axis of that size would give (the mesh's by default)."""
    n_model = mesh.shape.get("model", 1) if n_model is None else n_model
    if isinstance(state, nn.Module):
        from cvaegan_tpu_torch.convert import net_leaves

        out = {}
        for name, net, stack in _networks(state):
            specs = {}
            for path, (tensor, transposed) in net_leaves(net).items():
                shape = tuple(tensor.shape)[::-1] if transposed else tuple(tensor.shape)
                if stack is None:
                    specs[path] = NamedSharding(mesh, _leaf_spec(shape, n_model))
                    continue
                spec = _leaf_spec((stack, *shape), n_model)
                lead, *rest = spec or (None,)
                if lead is not None:  # a stacked scalar: not a network leaf
                    raise ValueError(f"{name}/{'/'.join(path)}: spec {spec} shards the stack")
                specs[path] = NamedSharding(mesh, P(*rest))
            out[name] = specs
        return out

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if hasattr(tree, "shape") and hasattr(tree, "dtype"):
            return NamedSharding(mesh, _leaf_spec(tuple(tree.shape), n_model))
        return NamedSharding(mesh, P())

    return walk(state)


def _leaves(shardings):
    if isinstance(shardings, NamedSharding):
        yield shardings
    elif isinstance(shardings, dict):
        for v in shardings.values():
            yield from _leaves(v)


def _paired(state, shardings):
    """(tensor, NamedSharding, torch dim of its 'model' axis or None) of
    every leaf `shardings` names: a trainer state's by network and Flax
    path, a mapping's by key."""
    if isinstance(state, nn.Module):
        from cvaegan_tpu_torch.convert import net_leaves

        nets = {name: net for name, net, _ in _networks(state)}
        for name, specs in shardings.items():
            leaves = net_leaves(nets[name])
            for path, sharding in specs.items():
                tensor, transposed = leaves[path]
                yield tensor, sharding, _model_dim(sharding.spec, tensor.dim(), transposed,
                                                   f"{name}/{'/'.join(path)}")
        return
    for key, sharding in shardings.items():
        if not isinstance(sharding, NamedSharding):
            yield from _paired(state[key], sharding)
        elif isinstance(state[key], torch.Tensor):
            yield state[key], sharding, _model_dim(sharding.spec, state[key].dim(), False, key)
        elif "model" in sharding.spec:
            raise TypeError(f"{key}: only a tensor can be sliced over 'model', "
                            f"not {type(state[key]).__name__}")


def _model_dim(spec: P, ndim: int, transposed: bool, what: str) -> Optional[int]:
    """The torch axis a spec (in the Flax layout) shards over 'model'."""
    if len(spec) > ndim or any(a not in (None, "model") for a in spec) or list(spec).count(
            "model") > 1:
        raise ValueError(f"{what}: spec {spec} for a leaf of {ndim} axes: the port shards "
                         "parameters over one axis of 'model' (the batch goes over 'data')")
    if "model" not in spec:
        return None
    dim = spec.index("model")
    return ndim - 1 - dim if transposed else dim


@torch.no_grad()
def place(state, shardings, optimizers: Optional[dict] = None):
    """Put a state onto its shardings, as `jax.device_put` does: every
    leaf first holds the first rank's whole value (a leaf `place` sliced
    before is gathered first), then each rank keeps, of a leaf whose spec
    names 'model', the contiguous block at its 'model' coordinate (the
    whole leaf on a 'model' axis of size 1), and of its Adam moments in
    `optimizers` the same block; counts and replicated leaves stay whole.
    A tensor is sliced in place (`.data`), so the modules and optimizers
    that hold it keep it, and it carries its `ModelShard` (`shard_of`).
    Returns `state`."""
    pairs = list(_paired(state, shardings))
    for tensor, sharding, dim in pairs:
        n, shape = sharding.mesh.shape["model"], _whole_shape(tensor)
        if dim is not None and shape[dim] % n:
            raise ValueError(f"a leaf of shape {tuple(shape)} does not divide into {n} "
                             f"'model' slices along axis {dim}")
    slots = {id(p): (opt, i) for opt in (optimizers or {}).values()
             for i, p in enumerate(opt.params)}
    tensors = [*state_tensors(state),
               *(t for opt in (optimizers or {}).values() for t in opt.tensors())]
    for t in tensors:  # back to whole leaves
        if shard_of(t) is not None:
            t.data = gather_leaf(t)
            delattr(t, _SHARD_ATTR)
    for mesh in {id(s.mesh): s.mesh for s in _leaves(shardings)}.values():
        broadcast(tensors, mesh)
    for tensor, sharding, dim in pairs:
        if dim is None:
            continue
        shard = ModelShard(sharding.mesh, dim)
        opt, i = slots.get(id(tensor), (None, None))
        moments = [] if opt is None else [opt.m[i], opt.v[i]]
        for t in (tensor, *moments):
            t.data = local_part(t.data, shard).clone()
            setattr(t, _SHARD_ATTR, shard)
    return state


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a state: a module's parameters and buffers, or a
    mapping's tensors."""
    if isinstance(state, nn.Module):
        return list(state.state_dict(keep_vars=True).values())
    if isinstance(state, dict):
        return [t for v in state.values() for t in state_tensors(v)]
    return [state] if isinstance(state, torch.Tensor) else []
