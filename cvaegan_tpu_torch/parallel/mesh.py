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
  * the 'model' axis: `shard_net_state` gives the JAX package's per-leaf
    specs, but tensor parallelism is not ported (ROADMAP A27), so `place`
    onto a 'model'-sharded spec raises.

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
    """Copy the first rank's `tensors` (coordinate 0 on both axes) to
    every rank of the mesh, in place: one flat broadcast per dtype and
    axis. Tensors on the CPU travel through the mesh's device."""
    global COLLECTIVES
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1).to(_device(mesh)) for i in idx])
        for axis in AXES:
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


def _networks(state: nn.Module, prefix: str = ""):
    """(name, network) of a trainer state: its networks, and each
    generator of a list of them (TMG-GAN's `gens`) as `name.i`."""
    for name, net in state.items() if isinstance(state, nn.ModuleDict) else [("", state)]:
        path = f"{prefix}{name}"
        if isinstance(net, (nn.ModuleList, nn.ModuleDict)):
            for i, sub in enumerate(net.values() if isinstance(net, nn.ModuleDict) else net):
                yield f"{path}.{i}", sub
        else:
            yield path, net


def shard_net_state(state, mesh: Mesh):
    """Per-leaf shardings of a state: for a mapping of arrays or tensors,
    the same mapping of `NamedSharding`s by `_leaf_spec` of each leaf's
    shape, as the JAX package's; for a trainer's `nn.ModuleDict`, `{network:
    {Flax path: NamedSharding}}` with each spec taken on the leaf's shape in
    the Flax layout (`convert.net_leaves`: a Dense weight `[out, in]` is
    the kernel `[in, out]`), so the specs equal the JAX package's for the
    same weights. An Adam moment mirrors its parameter's spec."""
    n_model = mesh.shape.get("model", 1)
    if isinstance(state, nn.Module):
        from cvaegan_tpu_torch.convert import net_leaves

        out = {}
        for name, net in _networks(state):
            out[name] = {
                path: NamedSharding(mesh, _leaf_spec(
                    tuple(tensor.shape)[::-1] if transposed else tuple(tensor.shape),
                    n_model))
                for path, (tensor, transposed) in net_leaves(net).items()}
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


def place(state, shardings, optimizers: Optional[dict] = None):
    """Put a state onto its shardings: replicated leaves are made equal on
    every rank of the mesh (the first rank's are broadcast, with the
    optimizers' tensors where given). A 'model'-sharded spec raises:
    tensor parallelism is not ported (ROADMAP A27)."""
    leaves = list(_leaves(shardings))
    if any("model" in s.spec for s in leaves):
        raise NotImplementedError(
            "place onto a 'model'-sharded spec: tensor parallelism over the mesh's "
            "'model' axis is not ported (ROADMAP A27); use a mesh of n_model=1 or "
            "replicated specs")
    tensors = [*state_tensors(state),
               *(t for opt in (optimizers or {}).values() for t in opt.tensors())]
    for mesh in {id(s.mesh): s.mesh for s in leaves}.values():
        broadcast(tensors, mesh)
    return state


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a state: a module's parameters and buffers, or a
    mapping's tensors."""
    if isinstance(state, nn.Module):
        return list(state.state_dict(keep_vars=True).values())
    if isinstance(state, dict):
        return [t for v in state.values() for t in state_tensors(v)]
    return [state] if isinstance(state, torch.Tensor) else []
