"""Shared building blocks, the counterparts of `cvaegan_tpu/models/layers.py`.

The reference builds every network from the same ingredients
(`src/models/cvae_gan_models.py`): Linear (with optional spectral norm),
BatchNorm1d, LeakyReLU(0.2), Dropout(0.3), and the hidden-size rule
h1=max(256,d), h2=max(128,d//2), h3=max(64,d//4) (discriminators and
classifiers pin h3=64).

Layouts and numerics follow the JAX package, not torch's built-ins:

  * `Dense` keeps torch's `[out, in]` weight; the JAX kernel is its
    transpose (`convert.py` carries weights across).
  * `BatchNorm` is written by hand: the running variance is updated with
    the BIASED batch variance, var = max(0, E[x^2] - E[x]^2), as Flax does;
    `torch.nn.BatchNorm1d` would use the unbiased one.
  * `SpectralDense` keeps the power-iteration vectors `u` [out] and `v`
    [in] as buffers and runs one iteration per train forward, without
    gradient; `torch.nn.utils.parametrizations.spectral_norm` iterates
    differently and normalises with max(|x|, eps).
  * The compute policy (`compute_dtype`, as in the JAX package): under
    "bfloat16" `Dense` and `SpectralDense` compute in bf16 from float32
    parameters (the product rounded to bf16, then the bias added in bf16,
    as JAX orders them); `BatchNorm` takes its statistics in float32 and
    returns the policy's dtype; `LayerNorm` computes in float32 and
    returns float32, as Flax's `nn.LayerNorm` does on a bf16 input. Under
    "float32" every cast is a no-op and the forwards are the float32 ones.
  * Every module reads `self.training`; a train-mode forward under
    `torch.no_grad()` still updates the BatchNorm statistics and `u`/`v`
    in place (the JAX package returns them as new mutables instead).
    Under `state_frozen(net)` a train-mode forward keeps batch statistics,
    dropout and the current `u`/`v` but updates nothing: the counterpart
    of a Flax apply whose new mutables are thrown away.
  * Tensor parallelism (`parallel/mesh.py`): a layer whose leaves `place`
    sliced over the mesh's 'model' axis (`mesh.shard_of`) computes its
    slice of the features. Every layer takes and returns whole
    activations, so the layers compose as they do unplaced (attention's
    head split runs on whole activations, unchanged), and on a 'model'
    axis of size 1 every placed forward is the plain one bitwise. The one
    exception is the choice made for BatchNorm: between a sliced `Dense`
    or `SpectralDense` and the `BatchNorm` after it, sliced alike, the
    activation stays sliced (`dense_bn`, at every such pair of the
    networks). Collectives over the model group, per forward and the
    backward it adds:
      - `Dense`, weight sliced by output rows: its input enters the model
        region (`enter_model`), the rank computes its output columns and
        `gather_model` makes them whole: 1 all-gather; backward 1 SUM
        all-reduce (the input's gradient). Weight replicated, bias sliced
        (TMG-GAN's generators): the bias is gathered, 1 all-gather.
      - `SpectralDense`, weight sliced: in train mode u W is summed over
        the ranks' rows (1 all-reduce) and W v gathered whole (1
        all-gather) and normalised whole; sigma takes its value from that
        W v and its gradient through each rank's own partial u_r W_r v
        (backward 1 all-reduce as it enters the sliced W / sigma); in
        eval mode or `state_frozen` a sliced v is gathered (1 all-gather)
        and sigma summed from the partials (1 all-reduce). Then as
        `Dense`. All of it float32 and outside autograd for u and v. A
        replicated weight with a sliced v (a critic's 1-wide head) only
        gathers v outside train mode.
      - `BatchNorm`, sliced by feature, after a layer sliced alike
        (`dense_bn`): none of its own; the pair gathers once forward and
        all-reduces once backward. Alone (after a replicated kernel): it
        slices its input (`split_model`) and gathers its output, 1
        all-gather forward and 1 backward. Its moments are per feature:
        no 'model' collective (inside `data_parallel` still summed over
        'data'); it updates its slice of the running statistics.
      - `LayerNorm`, and CTGAN's mode affine: statistics over the whole
        row as unplaced; sliced scale and bias are gathered, 1 all-gather
        of both (`whole_features`).
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core import initializers as init
from cvaegan_tpu_torch.parallel import mesh as mesh_lib
from cvaegan_tpu_torch.utils import profiling

LEAKY_SLOPE = 0.2
#: the policy's names and their dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the dtype a `dtype_override` block pins, and the policy of the trainer
#: whose method is running (`policy`)
_OVERRIDE: Optional[torch.dtype] = None
_POLICY: Optional[torch.dtype] = None


def compute_dtype() -> torch.dtype:
    """The matmul/activation dtype in force (`cvaegan_tpu/models/layers.py:
    31-42`): a `dtype_override` block's, else the running trainer's policy
    (`policy`), else the process-wide `config.settings.gan.compute_dtype`.
    Read at every forward, so a captured CUDA graph keeps the dtype it was
    captured under: the trainers key their captures on it."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    if _POLICY is not None:
        return _POLICY
    config_lib.check_compute_dtype(config_lib.settings.gan)
    return DTYPES[config_lib.settings.gan.compute_dtype]


@contextlib.contextmanager
def dtype_override(dtype):
    """Pin `compute_dtype()` to `dtype` (a name or a torch dtype) inside the
    block, whatever the policy (`cvaegan_tpu/models/layers.py:45-62`): the
    downstream classifier stays float32 while the models under study run
    bf16. Wrap the region where a CUDA graph is captured, not only where it
    is replayed."""
    global _OVERRIDE
    old, _OVERRIDE = _OVERRIDE, DTYPES.get(dtype, dtype)
    try:
        yield
    finally:
        _OVERRIDE = old


@contextlib.contextmanager
def policy(gan_cfg: config_lib.GanConfig):
    """Run the block under `gan_cfg.compute_dtype` (a trainer's settings);
    a `dtype_override` block around it still wins."""
    global _POLICY
    config_lib.check_compute_dtype(gan_cfg)
    old, _POLICY = _POLICY, DTYPES[gan_cfg.compute_dtype]
    try:
        yield
    finally:
        _POLICY = old


def hidden_sizes(total_input_dim: int, pin_h3: bool = False) -> Tuple[int, int, int]:
    """Reference hidden-size rule (`src/models/cvae_gan_models.py:16-18`,
    `:173-175` for the pinned variant)."""
    h1 = max(256, total_input_dim)
    h2 = max(128, total_input_dim // 2)
    h3 = 64 if pin_h3 else max(64, total_input_dim // 4)
    return (h1, h2, h3)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels -> float32 one-hot."""
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def widened(x: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as float32; any other as it is (float32, or float64 in
    a reference run, which the policy never narrows)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def to_compute(x: torch.Tensor) -> torch.Tensor:
    """`x` in the bf16 policy's dtype; as it is under float32, whose casts
    are no-ops in the JAX package too."""
    dt = compute_dtype()
    return x if dt == torch.float32 else x.to(dt)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x W^T + b in the compute dtype, as the JAX package's `Dense`:
    `x.astype(dt) @ k.astype(dt)`, then `+ bias.astype(dt)`. Under bf16
    the product is rounded to bf16 before the bias is added; `F.linear`
    with its bias may fuse the add into the GEMM's epilogue and round once,
    so the bias is added apart. In float32 both orders round alike."""
    dt = compute_dtype()
    if dt == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


class Dense(nn.Module):
    """Linear layer with the reference's N(0, 0.02)/zeros init."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_from(self, generator: torch.Generator) -> None:
        init.dense_kernel_(self.weight, generator)
        if self.bias is not None:
            init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = mesh_lib.shard_of(self.weight)
        if rows is None:
            return dense(x, self.weight, mesh_lib.whole(self.bias))
        return mesh_lib.gather_model(self.columns(x, rows), rows)

    def columns(self, x: torch.Tensor, rows: "mesh_lib.ModelShard") -> torch.Tensor:
        """This rank's output columns of a weight sliced by output rows."""
        return _columns(x, self.weight, self.bias, rows)


def _columns(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             rows: "mesh_lib.ModelShard") -> torch.Tensor:
    """This rank's output columns of x W^T + b for a weight sliced by
    output rows (`rows`); `x` is whole and enters the model region."""
    if rows.dim != 0:
        raise ValueError(f"a Dense weight sliced along axis {rows.dim}: the port slices "
                         "a kernel [in, out] over its output features only")
    if bias is not None and mesh_lib.shard_of(bias) is None:
        bias = mesh_lib.split_model(bias, rows)
    return dense(mesh_lib.enter_model(x, rows), weight, bias)


class SpectralDense(nn.Module):
    """Linear layer with spectral normalisation by one power-iteration
    step per train forward (reference `src/models/cvae_gan_models.py:
    178-189`).

    In the JAX layout K = weight.T [in, out]: v = n(K u), u = n(K^T v),
    sigma = v^T K u, with n(x) = x / (|x| + 1e-12). Here that reads
    v = n(u W), u = n(W v), sigma = u^T W v. Gradients reach the weight
    through sigma but not through `u`/`v`. The power iteration and sigma
    stay float32 under any policy; W / sigma is cast for the product.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        #: False under `state_frozen`: no power iteration in train mode
        self.update_state = True
        self.register_buffer("u", torch.zeros(features))
        self.register_buffer("v", torch.zeros(in_features))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        init.dense_kernel_(self.weight, generator)
        if self.bias is not None:
            init.zeros_(self.bias)
        self.u.copy_(_l2_normalize(self.u.normal_(generator=generator)))
        self.v.copy_(_l2_normalize(self.v.normal_(generator=generator)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = mesh_lib.shard_of(self.weight)
        if rows is None:
            return dense(x, self._scaled(rows), mesh_lib.whole(self.bias))
        return mesh_lib.gather_model(self.columns(x, rows), rows)

    def columns(self, x: torch.Tensor, rows: "mesh_lib.ModelShard") -> torch.Tensor:
        """This rank's output columns of a weight sliced by output rows."""
        return _columns(x, self._scaled(rows), self.bias, rows)

    def _scaled(self, rows: Optional["mesh_lib.ModelShard"]) -> torch.Tensor:
        """W / sigma (this rank's rows of it), after one power iteration
        in train mode unless frozen. Sliced rows: sigma's value is taken
        on the whole gathered W v where the iteration gives it (else summed
        from the ranks' partial dot products), and its gradient reaches
        each rank's rows through its own partial; it enters the sliced
        W / sigma through `enter_model`."""
        if mesh_lib.shard_of(self.u) != rows:
            raise ValueError("a SpectralDense's u is placed unlike its weight's rows")
        wv = None
        if self.training and self.update_state:
            with torch.no_grad():
                v = _l2_normalize(mesh_lib.model_sum(self.u @ self.weight, rows))
                wv = mesh_lib.gather_model(self.weight @ v, rows)
                u = _l2_normalize(wv)
                self.u.copy_(mesh_lib.local_part(u, rows))
                self.v.copy_(mesh_lib.local_part(v, mesh_lib.shard_of(self.v)))
        else:
            v = mesh_lib.gather_leaf(self.v)
        sigma = torch.dot(self.u, self.weight @ v)
        if rows is None:
            return self.weight / sigma
        if wv is None:
            sigma = mesh_lib.model_sum(sigma, rows)
        else:  # the whole value, without a collective; the partial's gradient
            sigma = torch.dot(u, wv) + (sigma - sigma.detach())
        return self.weight / mesh_lib.enter_model(sigma, rows)


def _moments(x: torch.Tensor, dim: int, keepdim: bool = False):
    """Mean and biased variance as Flax computes them: E[x^2] - E[x]^2,
    clipped at 0, in float32."""
    mean = x.mean(dim, keepdim=keepdim)
    var = torch.clamp_min((x * x).mean(dim, keepdim=keepdim) - mean * mean, 0.0)
    return mean, var


def _global_moments(x: torch.Tensor, layout: "mesh_lib.RowLayout"):
    """`_moments` over the rows of the global batch: every data rank's sums
    of x and x^2 and its row count, summed over the data axis in one
    differentiable all-reduce (`parallel/mesh.py`)."""
    n = x.new_full((1,), float(x.shape[0]))
    sums = mesh_lib.all_reduce(torch.cat([x.sum(0), (x * x).sum(0), n]), layout.group)
    f = x.shape[1]
    mean = sums[:f] / sums[-1]
    var = torch.clamp_min(sums[f:2 * f] / sums[-1] - mean * mean, 0.0)
    return mean, var


class BatchNorm(nn.Module):
    """BatchNorm1d with Flax's statistics: momentum 0.9 on the running
    averages (torch's 0.1), eps 1e-5, scale ~ N(1, 0.02), bias 0
    (`src/utils.py:99-101`), biased running variance. The statistics are
    taken in float32 on `widened(x)`, and the output is cast by
    `to_compute`. Inside a mesh's `data_parallel` the train-mode moments
    are the global batch's (`_global_moments`), so the running statistics
    are equal on every rank."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        #: False under `state_frozen`: batch statistics, no running update
        self.update_state = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_from(self, generator: torch.Generator) -> None:
        init.bn_scale_(self.weight, generator)
        init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = _feature_shard(self.weight, self.bias, self.running_mean, self.running_var)
        return mesh_lib.gather_model(self._normalize(mesh_lib.split_model(x, shard)), shard)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        x = widened(x)
        if self.training:
            layout = mesh_lib.batch_layout()
            mean, var = _moments(x, 0) if layout is None else _global_moments(x, layout)
            if self.update_state:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return to_compute((x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                          + self.bias)


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(epsilon=1e-5)`: scale 1, bias 0, statistics as
    `_moments` computes them over the last axis. It computes in float32
    and returns float32 whatever the input's dtype, as Flax's does with
    float32 parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = widened(x)
        mean, var = _moments(x, -1, keepdim=True)
        scale, bias = whole_features(self.weight, self.bias)
        return (x - mean) * (torch.rsqrt(var + self.eps) * scale) + bias


def _feature_shard(*leaves: torch.Tensor) -> Optional["mesh_lib.ModelShard"]:
    """The one placement of a layer's per-feature leaves (None unplaced);
    leaves placed unlike each other raise."""
    shards = {mesh_lib.shard_of(t) for t in leaves}
    if len(shards) > 1:
        raise ValueError("a layer's per-feature leaves are placed unlike each other: "
                         "place them with one spec")
    return shards.pop()


def whole_features(*leaves: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Leaves of one shape sliced alike along their last (feature) axis,
    whole: one all-gather of them stacked (differentiable); as they are
    unplaced."""
    shard = _feature_shard(*leaves)
    if shard is None:
        return leaves
    if shard.dim != leaves[0].dim() - 1:
        raise ValueError(f"per-feature leaves sliced along axis {shard.dim}, not their "
                         "feature axis")
    return tuple(mesh_lib.gather_model(torch.stack(leaves), shard).unbind(0))


@contextlib.contextmanager
def state_frozen(net: nn.Module):
    """Inside the block, train-mode forwards of `net` leave its BatchNorm
    running statistics and spectral `u`/`v` as they are (a second forward
    that must see the first one's sigma, as CTGAN's gradient penalty
    does)."""
    layers = [m for m in net.modules() if hasattr(m, "update_state")]
    for m in layers:
        m.update_state = False
    try:
        yield net
    finally:
        for m in layers:
            m.update_state = True


def forward_with(module: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """`module(*args)`, passing `generator` where the module's forward takes
    one (it draws dropout masks from it). Companion classifiers differ:
    the MLP and CTGAN ones drop out, the RAIN and SNGAN ones do not."""
    if "generator" in inspect.signature(module.forward).parameters:
        return module(*args, generator=generator)
    return module(*args)


@profiling.spanned("step.draw")
def _keep_mask(x: torch.Tensor, keep_prob: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The keep-mask of `x`'s rows; under a mesh, those rows of the global
    batch's mask (`mesh.local_draw`)."""
    return mesh_lib.local_draw(
        lambda shape: torch.rand(shape, generator=generator, device=x.device),
        x.shape) < keep_prob


class Dropout(nn.Module):
    """Inverted dropout drawing its mask from an explicit generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = _keep_mask(x, keep_prob, generator)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dense_bn(layer: nn.Module, bn: "BatchNorm", x: torch.Tensor) -> torch.Tensor:
    """`bn(layer(x))` for a `Dense` or `SpectralDense` and the `BatchNorm`
    after it. Where both are sliced alike over 'model', the activation
    stays sliced between them: the pair takes one all-gather forward and
    one all-reduce backward, where apart it would take two of each."""
    rows = mesh_lib.shard_of(layer.weight)
    if rows is None or _feature_shard(bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var) != rows:
        return bn(layer(x))
    return mesh_lib.gather_model(bn._normalize(layer.columns(x, rows)), rows)


class MLPTrunk(nn.Module):
    """The reference's 3x [Linear -> BatchNorm -> LeakyReLU(0.2)] stack
    (`src/models/cvae_gan_models.py:20-33`)."""

    def __init__(self, in_features: int, hidden: Sequence[int]):
        super().__init__()
        dims = [in_features, *hidden]
        self.dense = nn.ModuleList(
            Dense(dims[i], dims[i + 1]) for i in range(len(hidden)))
        self.bn = nn.ModuleList(BatchNorm(h) for h in hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, bn in zip(self.dense, self.bn):
            x = leaky_relu(dense_bn(dense, bn, x))
        return x
