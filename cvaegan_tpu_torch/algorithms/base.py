"""The uniform trainer API, the counterpart of `cvaegan_tpu/algorithms/base.py`.

Reference API parity (`src/cvae_gan.py:59,339,347,380,263`):
fit(dataset), generate_samples(label, num),
generate_qualified_samples(label, num, threshold),
reconstruct_samples(samples, labels), loss_history, plot_loss_history().

Execution model: each trainer holds its networks as an `nn.ModuleDict`
on an explicit device (`device="cuda"` unless the caller asks for the
CPU), one `core.state.Adam` per network, and one `torch.Generator` on
that device, seeded from `seed=` or `settings.seed`, for every random
draw. Weights are drawn on the CPU from a generator with the same seed,
so a seed gives the same weights on every device.

Training: the JAX package compiles a whole epoch (classes x (5 D + 5 C +
3 G) optimizer steps) into one XLA program. The port's counterpart is one
CUDA graph per epoch: on CUDA, `fit` captures the epoch once (after a
warm-up of one step of each kind on the capture stream, whose effects on
the state and the generator are undone) and replays it once per epoch;
the epoch number is copied into a device scalar before each replay, and
the trainer's generator is registered with the graph, so each replay
draws fresh noise. A capture reads nothing of the data on the host but
which classes are present, so it is kept per present-class pattern and
serves every dataset of the same shapes: `fit` and the windows of
`fit_streamed` refill its tensors in place. Running the same epoch
function without capture is the plain version: it is what runs on the
CPU, and on CUDA only when `fit` is asked for it with `eager=True` or
runs inside `utils.profiling.nan_debug()`. A failed capture raises.

Compute policy: a trainer runs its fits and its generation under its
settings' `gan.compute_dtype` (`models.layers.policy`, entered by
`under_policy`): "float32", or "bfloat16" as in the JAX package
(`cvaegan_tpu/core/config.py:35-51`). Parameters, optimizer state and
losses stay float32, a capture and the generation caches are kept per
policy (`_policy_key`), and generation returns float32 arrays.
`generate_samples_fast` runs the float32 fused kernel under either
policy, as JAX's does.

Spans (`utils.profiling.span`, on while a `torch.profiler` session
records): `fit` (a `fit` call, and each window of `fit_streamed`),
`fit.prepare`, `fit.capture`, `fit.epochs` (one chunk's epochs through
the transfer of their losses) and `fit.chunk_end`; the phases of a step,
`step.d`, `step.c` and `step.eg` (CVAE-GAN's and RAIN-GAN's E+G steps;
other trainers' own steps count to no phase), `step.adam`, `step.draw`
(every draw method and dropout mask) and `net.attention` (each attention
forward of RAIN-GAN's networks), which during a capture also mark whose
kernel nodes are whose; and the fast path's `gen.fast`,
`gen.draw`, `gen.fold`, `gen.forward` and `gen.copy`. Counts:
`fit.captures`, `fit.replays`, `gen.fold_builds`, `gen.pinned_copies`,
`gen.copy_blocks`.

Out of core: `fit_streamed` streams an (x, y) CSV pair through windows of
a fixed row count, each trained for a number of epochs with the state
kept (`cvaegan_tpu/algorithms/base.py:347-458`). With `checkpoint_dir`
set, `fit` and `fit_streamed` save a checkpoint after every
`epoch_chunk` epochs (`utils/checkpoint.py`).

The steps are written once for a trainer and for a seed bank of K of them
(`algorithms/seed_bank.py`): batches are concatenated and split on the
batch axis counted from the end, the losses keep leading axes, and every
random input comes from the draw methods (`_sample_batch`,
`_sample_labels`, `_random_batch`, `_uniform`, `_normal` and so `_prior`,
`_labels`) and the class rounds from `_rounds`, which the bank replaces
by per-replica versions.
"""

from __future__ import annotations

import copy
import functools
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.schedules import progressive_lambda
from cvaegan_tpu_torch.core.state import (
    Adam,
    adam,
    apply_eval,
    apply_train,
    capture_graphs,
    grad_update,
    resolve_device,
)
from cvaegan_tpu_torch.data.sampler import (
    ClassIndex,
    present_labels,
    sample_balanced_batch,
    sample_class_batch,
    sample_random_batch,
)
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.kernels import fused_mlp as fused
from cvaegan_tpu_torch.models import layers, mlp
from cvaegan_tpu_torch.models.layers import forward_with, one_hot
from cvaegan_tpu_torch.parallel import mesh as mesh_lib
from cvaegan_tpu_torch.parallel.mesh import shard_leading
from cvaegan_tpu_torch.utils import profiling
from cvaegan_tpu_torch.utils.checkpoint import save_checkpoint
from cvaegan_tpu_torch.utils.profiling import nan_debug_active

QUALIFIED_PATIENCE = 20
PRINT_EVERY = 50
#: captured epochs a trainer keeps, one per present-class pattern
MAX_GRAPHS = 8
#: rows of one block of the fast path on the card: B1 runs on the blocks
#: in turn, and each block's copy to the host runs beside the next
#: block's kernel
COPY_BLOCK_ROWS = 1 << 17


def under_policy(method):
    """Run a trainer method under the trainer's compute policy
    (`layers.policy(self.gan_cfg)`); a `layers.dtype_override` block
    around the call still wins."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with layers.policy(self.gan_cfg):
            return method(self, *args, **kwargs)
    return wrapped


def row_blocks(n: int) -> List[Tuple[int, int]]:
    """[start, stop) of consecutive blocks of at most `COPY_BLOCK_ROWS`
    rows that cover `n` rows in order: one block for 0 < n <=
    `COPY_BLOCK_ROWS`, none for 0."""
    return [(start, min(start + COPY_BLOCK_ROWS, n))
            for start in range(0, n, COPY_BLOCK_ROWS)]


def _forward_pinned(z: torch.Tensor, onehot: torch.Tensor, params, final: str
                    ) -> Tuple[torch.Tensor, torch.cuda.Event]:
    """The fast path's forward on the card, its rows written into one
    page-locked tensor of torch's caching host allocator: B1 runs on
    `row_blocks` of the one concat(z, onehot) on the current stream, and
    a side stream copies each block out once its kernel has ended, while
    the next block runs. Returns the host tensor and the event recorded
    after its last copy: read the rows only once that event has passed.
    The tensor belongs to the array made from it, and the allocator takes
    it back only once that array is dropped, so no later call writes into
    rows a caller holds."""
    weights, biases = params
    x = torch.cat([z, onehot], dim=-1)
    host = torch.empty((x.shape[0], weights[3].shape[1]), dtype=torch.float32,
                       pin_memory=True)
    compute = torch.cuda.current_stream(x.device)
    side = torch.cuda.Stream(x.device)
    blocks = row_blocks(x.shape[0])
    for start, stop in blocks:
        rows = fused.fused_mlp4(x[start:stop], weights, biases, final=final)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            host[start:stop].copy_(rows, non_blocking=True)
        rows.record_stream(side)  # its memory is not reused before the copy ends
    copied = torch.cuda.Event()
    copied.record(side)
    profiling.count("gen.pinned_copies")
    profiling.count("gen.copy_blocks", len(blocks))
    return host, copied


def _as_arrays(dataset) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(dataset, TabularDataset):
        return dataset.tr_samples, dataset.tr_labels
    if hasattr(dataset, "as_tuple"):  # compat.TrDataset / TeDataset
        x, y = dataset.as_tuple()
        return np.asarray(x, np.float32), np.asarray(y, np.int32)
    if isinstance(dataset, tuple) and len(dataset) == 2:
        return np.asarray(dataset[0], np.float32), np.asarray(dataset[1], np.int32)
    raise TypeError("expected a TabularDataset, a compat TrDataset/TeDataset or an "
                    f"(samples, labels) tuple, got {type(dataset)!r}")


def _data_bytes(samples: np.ndarray, labels: np.ndarray, index: ClassIndex) -> int:
    """Bytes a fit's data takes to the device: rows, labels and the class
    index."""
    return int(samples.nbytes + labels.nbytes
               + sum(t.numel() * t.element_size() for t in (index.table, index.counts)))


class GenerativeTrainer:
    """Base class. Subclasses set `name`, `config_key`, `loss_keys` and
    `loops` and implement `_build`, `_jax_dims` and `_round` (one class
    round of D/C/G steps); the epoch, the warm-up before capture, the
    optimizers and the conditional generator's serving are the base's
    unless a subclass overrides them."""

    name: str = "base"
    config_key: str = ""
    loss_keys: Tuple[str, ...] = ()
    #: the kinds of optimizer step of one class round, each run
    #: `settings.gan.<kind>_loop_num` times
    loops: Tuple[str, ...] = ()
    #: epochs whose losses come back to the host in one transfer.
    epoch_chunk: int = 500
    #: set False to silence the progress prints.
    verbose: bool = True
    #: a directory: `fit` and `fit_streamed` save a checkpoint there after
    #: every `epoch_chunk` epochs (`utils/checkpoint.py`)
    checkpoint_dir = None
    conditional_sampling: bool = True
    #: the network that maps z (and labels) to samples
    decoder_name: str = "generator"

    def __init__(self, seed: Optional[int] = None,
                 settings: Optional[config_lib.Settings] = None,
                 device="cuda", balanced_mode: bool = False,
                 ema_filter: bool = False):
        self.settings = settings or config_lib.settings
        self.gan_cfg = self.settings.gan
        config_lib.check_compute_dtype(self.gan_cfg)
        self.device = resolve_device(device)
        #: filter qualified samples with an EMA copy of the companion
        #: classifier (kept in the state as `classifier_ema`, updated once
        #: per epoch).
        self.ema_filter = ema_filter
        self.ema_decay = 0.99
        #: one class-balanced mixed D/C/G round per epoch instead of the
        #: reference's per-class round-robin.
        self.balanced_mode = balanced_mode
        self.hparams = dict(config_lib.MODEL_CONFIGS.get(self.config_key, {}))
        self.seed = self.settings.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.feature_num: int = 0
        self.label_num: int = 0
        self.state: Optional[nn.ModuleDict] = None
        self.optimizers: Dict[str, Adam] = {}
        self._data: Optional[Dict] = None
        self.loss_history: Dict[str, list] = {k: [] for k in self.loss_keys}
        #: generation caches since the state last changed, one namespace
        #: per policy (`_gen_cache`): the qualified candidate capacities,
        #: and the fast path's fold of a placed generator
        self._gen_caches: Dict[str, dict] = {}
        #: the `_placement_key` the captures and caches were made under
        self._placement: Optional[tuple] = None
        #: the epoch number and the epoch's losses, on the device: a
        #: captured epoch reads the one and writes the other
        self._epoch_t = torch.zeros((), dtype=torch.float32, device=self.device)
        self._losses_out = torch.zeros(len(self.loss_keys), device=self.device)
        #: (key, CUDAGraph) of the captured epoch last replayed, and every
        #: capture kept, by key (one per present-class pattern)
        self._graph = None
        self._graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}

    # ------------------------------------------------------- subclass hooks
    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        """Create the networks, initialised from `init_generator`, on
        `self.device`."""
        raise NotImplementedError

    def _build_optimizers(self, nets: Dict[str, nn.Module]) -> Dict[str, Adam]:
        """One Adam per trained network: `g_lr` for the encoder, the
        generator or decoder and QG-SMOTE's quantile regressor, `d_lr` for
        the critic, `c_lr` for the companion classifier, betas
        `adam_b1`/`adam_b2`."""
        cfg = self.gan_cfg
        lrs = {"encoder": cfg.g_lr, "generator": cfg.g_lr, "decoder": cfg.g_lr,
               "regressor": cfg.g_lr, "discriminator": cfg.d_lr, "classifier": cfg.c_lr}
        return {k: adam(net, lrs[k], cfg.adam_b1, cfg.adam_b2)
                for k, net in nets.items() if k in lrs}

    #: fills the state and the optimizers from a JAX state tree
    #: (`load_jax_state`)
    _state_from_jax = staticmethod(convert.state_from_jax)

    @staticmethod
    def _jax_dims(tree) -> Tuple[int, Optional[int], int]:
        """(feature_num, label_num, z_size) of the JAX trainer's state tree;
        label_num is None where no network of the tree depends on it."""
        raise NotImplementedError

    def _round(self, class_id: Optional[int], epoch: torch.Tensor,
               counts: Dict[str, int]) -> Dict[str, torch.Tensor]:
        """One class round at the epoch number `epoch` (a device scalar):
        `counts[kind]` steps of each kind of `loops`, in order, every
        random input drawn through the draw methods. Returns the losses of
        its last step by `loss_keys`."""
        raise NotImplementedError

    def _loop_counts(self) -> Dict[str, int]:
        """Steps of each kind of `loops` in one class round:
        `settings.gan.<kind>_loop_num`."""
        cfg = self.gan_cfg
        return {kind: getattr(cfg, f"{kind}_loop_num") for kind in self.loops}

    def _epoch_body(self, epoch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training epoch: every class round with `_loop_counts` steps
        of each kind; the losses are the last round's."""
        counts = self._loop_counts()
        return self._rounds(lambda class_id: self._round(class_id, epoch, counts))

    def _on_chunk_end(self, epochs_done: int) -> None:
        """Called by `fit` after each `epoch_chunk` epochs, once their
        losses are on the host and `self.state` is current (a no-op
        unless a subclass records something, as RAIN-GAN's attention
        history does). On CUDA it runs between replays, outside the
        graph, so it may only read: eval-mode forwards, which change no
        BatchNorm statistic, spectral u/v or generator state the graph
        reads."""

    def _warm_up(self) -> None:
        """One optimizer step of each kind the epoch runs, before capture."""
        self._round(self._class_rounds()[0], self._epoch_t, dict.fromkeys(self.loops, 1))

    def _build_state(self) -> nn.ModuleDict:
        """`_build`, the optional EMA-filter copy of the classifier, and the
        optimizers."""
        nets = self._build(torch.Generator().manual_seed(self.seed))
        if self.ema_filter and "classifier" in nets:
            nets["classifier_ema"] = copy.deepcopy(nets["classifier"])
        self.optimizers = self._build_optimizers(nets)
        self._drop_graphs()
        self._clear_gen_caches()
        return nn.ModuleDict(nets)

    def _drop_graphs(self) -> None:
        """Forget every captured epoch (the tensors it reads changed)."""
        self._graph = None
        self._graphs = {}

    @staticmethod
    def _policy_key() -> str:
        """The compute dtype in force, as a key of captures and caches
        (`cvaegan_tpu/algorithms/base.py:258-271`)."""
        return str(layers.compute_dtype()).removeprefix("torch.")

    @property
    def _gen_cache(self) -> dict:
        """The generation cache of the policy in force: flipping the policy
        starts another namespace and keeps the old one, as the JAX package
        keys its generation programs (`cvaegan_tpu/algorithms/base.py:
        115-130`). A `parallel.mesh.place` of the state since the caches
        were filled clears them all (`_check_placement`)."""
        self._check_placement()
        return self._gen_caches.setdefault(self._policy_key(), {})

    def _placement_key(self) -> tuple:
        """`parallel.mesh.placement_key` of every state and optimizer
        tensor: `place` changes it (storage, shapes, `ModelShard`s)."""
        return mesh_lib.placement_key(self._static_tensors()[:-1])

    def _check_placement(self) -> None:
        """Forget every capture and generation cache if the state was
        placed (`parallel.mesh.place`) since they were made: a kept graph
        would replay over freed tensors, a cached fold hold old leaves."""
        key = self._placement_key()
        if key != self._placement:
            self._drop_graphs()
            self._gen_caches.clear()
            self._placement = key

    def _clear_gen_caches(self) -> None:
        """Forget every policy's generation cache: the state changed (a fit
        ended, or the state was built, loaded or handed over by a seed
        bank), as the JAX package drops its generation programs."""
        self._gen_caches.clear()

    def _filter_state(self, state):
        """State used by the qualified-sample FILTER: the EMA classifier
        when enabled, the live one otherwise."""
        if "classifier_ema" in state:
            return {**dict(state.items()), "classifier": state["classifier_ema"]}
        return state

    def _generator_forward(self, state, z: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
        """Eval-mode generator forward -> samples [n, feature_num]: the
        conditional `generator`'s, unless a subclass has another."""
        x, _ = apply_eval(state["generator"], z, labels)
        return x

    def _classifier_logits(self, state, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Eval-mode companion-classifier logits, or None if the algorithm
        has no companion classifier."""
        if "classifier" not in state:
            return None
        return apply_eval(state["classifier"], x)

    def _lambda_class(self, epoch: torch.Tensor) -> torch.Tensor:
        """The generator's class-loss weight at `epoch`: 0 before epoch
        200, a linear ramp to `lambda_class` at 500 (reference
        `src/cvae_gan.py:198-204`)."""
        return progressive_lambda(epoch, self.hparams["lambda_class"], 200, 500)

    # ------------------------------------------------------------- sampling
    @profiling.spanned("step.draw")
    def _sample_batch(self, class_id: Optional[int]):
        """(x_real, labels) for one conditional update: rows of class
        `class_id` in strict mode, a class-balanced mixed batch in
        balanced_mode (where `class_id` is None)."""
        bs, data = self.gan_cfg.batch_size, self._data
        if self.balanced_mode:
            return sample_balanced_batch(self.generator, data["index"],
                                         data["samples"], bs)
        x = sample_class_batch(self.generator, data["index"], data["samples"],
                               class_id, bs)
        return x, shard_leading(self._labels(class_id, bs))

    @profiling.spanned("step.draw")
    def _sample_labels(self, class_id: Optional[int]) -> torch.Tensor:
        """Labels for updates that need no real batch: the target class in
        strict mode, uniform over the present classes in balanced_mode."""
        bs = self.gan_cfg.batch_size
        if self.balanced_mode:
            return shard_leading(present_labels(self.generator, (bs,), self._data["index"]))
        return shard_leading(self._labels(class_id, bs))

    @profiling.spanned("step.draw")
    def _random_batch(self):
        """(x_real, labels): a uniform batch over the whole train set, for
        the unconditional family."""
        data = self._data
        return sample_random_batch(self.generator, data["samples"], data["labels"],
                                   self.gan_cfg.batch_size)

    def _class_rounds(self) -> List[Optional[int]]:
        """The class rounds of one epoch: one mixed round (None) in
        balanced_mode, else one round per PRESENT class in order. The JAX
        package scans every class and masks the absent ones' rounds
        (`_guard_class_round`), recording the last present round's losses;
        the port's data is fixed for the whole fit, so the absent rounds
        are left out when the epoch is built, with the same result."""
        if self.balanced_mode:
            return [None]
        return [int(c) for c in self._data["index"].present()]

    def _rounds(self, round_fn):
        """`round_fn(class_id)` for each class round of the epoch, in order;
        returns the last round's losses."""
        out = None
        for class_id in self._class_rounds():
            out = round_fn(class_id)
        return out

    def _steps_per_epoch(self) -> int:
        """Optimizer steps of one epoch."""
        return len(self._class_rounds()) * sum(self._loop_counts().values())

    def _replica_steps_per_epoch(self) -> int:
        """Optimizer steps of one epoch, summed over the replicas it trains
        (a seed bank's; a trainer is one)."""
        return self._steps_per_epoch()

    def _generators(self) -> List[torch.Generator]:
        """Every generator an epoch draws from (a seed bank has one per
        replica)."""
        return [self.generator]

    # ---------------------------------------------------------------- steps
    # The critic and companion-classifier steps the adversarial trainers
    # share; `y` is None for an unconditional critic.
    def _fake(self, z: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
        """Generator output in train mode under no-grad: its BatchNorm
        statistics update (torch `.train()` + `no_grad`,
        `src/cvae_gan.py:110-113`)."""
        x_fake, _ = apply_train(self.state["generator"], z, y)
        return x_fake

    @profiling.spanned("step.d")
    def _d_step(self, x_real, y, z) -> torch.Tensor:
        """Critic update: -E[D(x,y)] + E[D(G(z,y),y)] (reference
        `src/cvae_gan.py:104-128`), one forward over concat(real, fake)
        with one spectral power iteration, as in the JAX package."""
        x_fake = self._fake(z, y)
        dis = self.state["discriminator"].train()
        yy = None if y is None else torch.cat([y, y], dim=-1)

        def loss_fn():
            scores, _ = dis(torch.cat([x_real, x_fake], dim=-2), yy, self.generator)
            d_real, d_fake = scores.chunk(2, dim=-2)
            return losses.wasserstein_d_loss(d_real, d_fake), None

        loss, _ = grad_update(self.optimizers["discriminator"], loss_fn)
        return loss.detach()

    @profiling.spanned("step.c")
    def _c_step(self, x_real, y, z=None) -> torch.Tensor:
        """Companion-classifier update: CE(real) + CE(fake) over one fused
        forward (reference `src/cvae_gan.py:131-157`), or CE(real) alone
        when `z` is None (the auxiliary classifier of the unconditional
        family, `src/gan.py:102-114`)."""
        x = x_real if z is None else torch.cat([x_real, self._fake(z, y)], dim=-2)
        clf = self.state["classifier"].train()

        def loss_fn():
            logits = forward_with(clf, x, generator=self.generator)
            if z is None:
                return losses.cross_entropy(logits, y), None
            real_logits, fake_logits = logits.chunk(2, dim=-2)
            return (losses.cross_entropy(real_logits, y)
                    + losses.cross_entropy(fake_logits, y)), None

        loss, _ = grad_update(self.optimizers["classifier"], loss_fn)
        return loss.detach()

    # ---------------------------------------------------------------- setup
    def _prepare(self, dataset) -> None:
        with profiling.span("fit.prepare") as sp:
            samples, labels = _as_arrays(dataset)
            self.feature_num = int(samples.shape[1])
            self.label_num = int(labels.max()) + 1 if labels.size else 0
            index = ClassIndex.build(labels, self.label_num, device=self.device)
            self._set_data(samples, labels, index)
            sp.set(rows=len(samples), bytes=_data_bytes(samples, labels, index))
            if self.state is None:
                self.state = self._build_state()
            mesh = mesh_lib.current_mesh()
            if mesh is not None:
                self._sync_ranks(mesh)

    def _sync_ranks(self, mesh) -> None:
        """Give every rank of `mesh` the first rank's networks, optimizer
        state and generator state: then each rank holds one model (of a
        state `place` sliced over 'model', the slices of its model
        coordinate: `mesh.broadcast`) and draws one global batch."""
        mesh_lib.broadcast(self._static_tensors()[:-1], mesh)
        mesh_lib.broadcast_generator(self.generator, mesh)
        self._clear_gen_caches()

    def _set_data(self, samples: np.ndarray, labels: np.ndarray, index: ClassIndex) -> None:
        """Give the epoch its data. Where the shapes match the data held,
        it is copied into the tensors a captured epoch reads, in place, and
        the captures stay valid (their draws read the class sizes on the
        device); else new tensors replace them and the captures go."""
        old = self._data
        if (old is not None and old["samples"].shape == samples.shape
                and old["index"].table.shape == index.table.shape):
            with torch.no_grad():
                old["samples"].copy_(torch.as_tensor(samples))
                old["labels"].copy_(torch.as_tensor(labels))
            old["index"].refill(index)
        else:
            self._data = {
                "samples": torch.as_tensor(samples, device=self.device),
                "labels": torch.as_tensor(labels, device=self.device),
                "index": index,
            }
            self._drop_graphs()

    def load_jax_state(self, tree) -> None:
        """Take the weights of the JAX trainer of the same name (plain
        nested dicts of numpy arrays, one per network, see
        `convert.state_from_jax`; a network's `opt_state` goes into its
        optimizer), building the networks from the tree's shapes if
        needed."""
        feature_num, label_num, z_size = self._jax_dims(tree)
        if label_num is None:  # no network of the tree knows the classes
            label_num = self.label_num
        if z_size != self.gan_cfg.z_size:
            raise ValueError(f"the tree's generator takes z of {z_size}, "
                             f"settings.gan.z_size is {self.gan_cfg.z_size}")
        if self.state is None or (feature_num, label_num) != (
                self.feature_num, self.label_num):
            self.feature_num, self.label_num = feature_num, label_num
            self.state = self._build_state()
        self._state_from_jax(tree, self.state, self.optimizers)
        self._clear_gen_caches()

    def _require_state(self) -> None:
        config_lib.check_compute_dtype(self.gan_cfg)
        if self.state is None:
            raise RuntimeError(f"{self.name}: no networks yet; call fit(), "
                               "_prepare() or load_jax_state() first")

    def _labels(self, target_label: int, num: int) -> torch.Tensor:
        return torch.full((num,), int(target_label), dtype=torch.int64,
                          device=self.device)

    @profiling.spanned("step.draw")
    def _uniform(self, shape) -> torch.Tensor:
        """float32 draws uniform on [0, 1) of `shape`."""
        return torch.rand(shape, generator=self.generator, device=self.device)

    @profiling.spanned("step.draw")
    def _normal(self, shape) -> torch.Tensor:
        """float32 standard normal draws of `shape`."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _prior(self, num: int) -> torch.Tensor:
        return self._normal((num, self.gan_cfg.z_size))

    def _z_batch(self) -> torch.Tensor:
        """Prior z of one training batch: this data rank's rows under a
        mesh (`shard_leading`, as the JAX package's steps shard theirs)."""
        return shard_leading(self._prior(self.gan_cfg.batch_size))

    def _eps_batch(self) -> torch.Tensor:
        """Reparameterisation noise of one training batch: this data rank's
        rows under a mesh (`local_rows`; the JAX package leaves this draw to
        GSPMD)."""
        return mesh_lib.local_rows(self._prior(self.gan_cfg.batch_size))

    # ------------------------------------------------------------------ fit
    @profiling.spanned("fit")
    def fit(self, dataset, eager: bool = False) -> None:
        """Train for `settings.gan.epochs` epochs. On CUDA each epoch is a
        replay of one captured CUDA graph; `eager=True` runs the plain
        version instead (the epoch op by op), as the CPU always does."""
        self._prepare(dataset)
        self._fit_prepared(self.gan_cfg.epochs, eager=eager)

    def fit_streamed(self, x_csv, y_csv, window_rows: int = 1_000_000,
                     epochs_per_window: int = 50, normalize: bool = True,
                     eager: bool = False) -> int:
        """Out-of-core training over an (x, y) CSV pair, as the JAX
        package's (`cvaegan_tpu/algorithms/base.py:347-458`): the pair
        streams through windows of `window_rows` rows (`StreamingCSV`, a
        native background reader, O(window) host memory), and each window
        is trained for `epochs_per_window` epochs (numbered from 0 in every
        window) with the networks and optimizers kept. Returns the number
        of windows.

        A window shorter than `window_rows` (the last) is padded by
        repeating its rows; its class index covers the real rows only, at
        a fixed width of `window_rows`. So every window has the shapes of
        the first and is copied in place into the tensors the captured
        epoch reads: one capture per present-class pattern serves them
        all. A window may lack classes: their rounds are left out of the
        epoch (JAX masks them, with the same result), and balanced-mode
        labels are drawn over the present classes. The unconditional
        family's uniform draws weigh the repeated rows of a padded window
        twice, as in JAX.

        y is one-hot (width = label_num) or one integer column (label_num
        from the first window). `normalize`: a first pass takes each
        column's min and max over the whole file, and every window is
        min-max scaled by them."""
        from cvaegan_tpu_torch.data.streaming import StreamingCSV, stream_minmax

        lo = scale = None
        if normalize:
            lo, hi = stream_minmax(x_csv, window_rows)
            scale = hi - lo
            scale[scale == 0] = 1.0
        n_windows = 0
        end = object()  # zip() would drop the longer stream's tail quietly
        for xw, yw in itertools.zip_longest(StreamingCSV(x_csv, window_rows),
                                            StreamingCSV(y_csv, window_rows), fillvalue=end):
            if xw is end or yw is end or len(xw) != len(yw):
                nx = "exhausted" if xw is end else len(xw)
                ny = "exhausted" if yw is end else len(yw)
                raise ValueError(f"x/y row mismatch at window {n_windows}: x {nx} rows "
                                 f"vs y {ny} — the CSV pair is misaligned")
            if normalize:
                xw = (xw - lo) / scale
            labels = (yw.argmax(axis=1) if yw.shape[1] > 1 else yw[:, 0]).astype(np.int32)
            if self.state is None and n_windows == 0:
                self.feature_num = int(xw.shape[1])
                self.label_num = (int(yw.shape[1]) if yw.shape[1] > 1
                                  else int(labels.max()) + 1)
            if int(xw.shape[1]) != self.feature_num:
                raise ValueError(f"window {n_windows}: {xw.shape[1]} features, "
                                 f"model built for {self.feature_num}")
            if labels.size and (labels.min() < 0 or labels.max() >= self.label_num):
                raise ValueError(
                    f"window {n_windows} holds class id {int(labels.max())} outside "
                    f"the model's {self.label_num} classes (integer-label corpora "
                    "infer label_num from the FIRST window — use one-hot y or "
                    "ensure every class appears early)")
            counts = np.bincount(labels, minlength=self.label_num)
            if (counts == 0).any() and self.verbose:
                missing = np.nonzero(counts == 0)[0].tolist()
                print(f"{self.name} window {n_windows}: classes {missing} absent — "
                      "their class rounds are skipped this window")
            with profiling.span("fit", window=n_windows):
                with profiling.span("fit.prepare", rows=len(xw)) as sp:
                    index = ClassIndex.build(labels, self.label_num, pad_to=window_rows,
                                             device=self.device)
                    n = len(xw)
                    if n < window_rows:  # pad by repeating the window's rows
                        reps = np.arange(window_rows - n) % n
                        xw = np.concatenate([xw, xw[reps]])
                        labels = np.concatenate([labels, labels[reps]])
                    xw = np.asarray(xw, np.float32)
                    self._set_data(xw, labels, index)
                    sp.set(bytes=_data_bytes(xw, labels, index))
                    if self.state is None:
                        self.state = self._build_state()
                        if mesh_lib.current_mesh() is not None:
                            self._sync_ranks(mesh_lib.current_mesh())
                self._fit_prepared(epochs_per_window, eager=eager)
            n_windows += 1
        if n_windows == 0:
            raise ValueError(f"empty corpus: {x_csv}")
        return n_windows

    @under_policy
    def _fit_prepared(self, epochs: int, eager: bool = False) -> None:
        """Run `epochs` epochs on `self._data`/`self.state`; the losses of
        each `epoch_chunk` epochs come to the host in one transfer, after
        which a checkpoint is saved if `checkpoint_dir` is set and the
        chunk hook runs. The plain epoch runs on the CPU, with
        `eager=True` and inside `nan_debug()` (a graph cannot raise).
        Under a mesh (`parallel.mesh.use_mesh`) the epochs run data
        parallel over its 'data' axis (`mesh.data_parallel`), with their
        collectives inside the captured epoch on CUDA."""
        self._require_state()
        with mesh_lib.data_parallel(self.gan_cfg.batch_size):
            self._run_epochs(epochs, eager)

    def _run_epochs(self, epochs: int, eager: bool) -> None:
        """The epochs in chunks of `epoch_chunk`, each a `fit.epochs` span
        (with the captured graph's kernel nodes, where it replays one)
        and a `fit.chunk_end` span."""
        chunk = max(1, min(self.epoch_chunk, epochs))
        graph = {}
        if eager or self.device.type != "cuda" or nan_debug_active():
            run = self._epoch
        else:
            run = self._captured_epoch()
            graph = {"graph_nodes": self._graph[1].node_counts}
        history = torch.zeros((chunk, *self._losses_out.shape), device=self.device)
        e = 0
        while e < epochs:
            n = min(chunk, epochs - e)
            with profiling.span("fit.epochs", epochs=n,
                                steps=n * self._replica_steps_per_epoch(), **graph):
                for i in range(n):
                    self._epoch_t.fill_(e + i)
                    run()
                    history[i].copy_(self._losses_out)
                losses = history[:n].cpu().numpy()
            if graph:
                profiling.count("fit.replays", n)
            with profiling.span("fit.chunk_end"):
                for j, k in enumerate(self.loss_keys):
                    self.loss_history[k].extend(losses[:, j].tolist())
                if self.verbose and self.loss_keys:
                    for i in range(0, n, PRINT_EVERY):
                        head = ", ".join(f"{k}: {losses[i, j]:.4f}"
                                         for j, k in enumerate(self.loss_keys))
                        print(f"{self.name} epoch {e + i}/{epochs}, {head}")
                e += n
                if self.checkpoint_dir is not None:
                    save_checkpoint(self, self.checkpoint_dir)
                self._clear_gen_caches()
                self._on_chunk_end(e)
        self._clear_gen_caches()

    def _epoch(self) -> None:
        """One epoch at `self._epoch_t`: the body, its losses into
        `self._losses_out`, and the EMA of the classifier's parameters
        (e <- d e + (1 - d) p, d = `ema_decay`). Reads no value on the
        host."""
        losses = self._epoch_body(self._epoch_t)
        with torch.no_grad():
            self._losses_out.copy_(torch.stack([losses[k] for k in self.loss_keys]))
            if "classifier_ema" in self.state:
                d = self.ema_decay
                ema = list(self.state["classifier_ema"].parameters())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    list(self.state["classifier"].parameters()), 1.0 - d))

    def _static_tensors(self) -> List[torch.Tensor]:
        """Every tensor an epoch updates in place."""
        tensors = list(self.state.state_dict(keep_vars=True).values())
        for opt in self.optimizers.values():
            tensors += opt.tensors()
        return [*tensors, self._losses_out]

    def _pattern(self) -> tuple:
        """Which classes the data holds: all of it a capture reads on the
        host."""
        return self._data["index"].pattern()

    def _capture_key(self):
        cfg = self.gan_cfg
        return (self._policy_key(), mesh_lib.current_mesh(), id(self.state),
                self._placement_key(), id(self._data["samples"]), self.balanced_mode,
                tuple(self._class_rounds()), self._pattern(),
                cfg.batch_size, cfg.d_loop_num, cfg.c_loop_num, cfg.g_loop_num,
                tuple(sorted(self.hparams.items())), self.ema_decay)

    def _captured_epoch(self):
        """The replay of this trainer's captured epoch, capturing it first
        unless a capture for the same policy, mesh (or none), state and
        placement, data tensors, mode, present classes and settings is
        kept (at most
        `MAX_GRAPHS`, the oldest dropped first). The warm-up's effects on
        the state and on every generator are undone before the capture.
        Captures made before a `place` of the state are dropped."""
        with profiling.span("fit.capture") as sp:
            self._check_placement()
            key = self._capture_key()
            sp.set(hit=key in self._graphs)
            if key in self._graphs:
                self._graph = (key, self._graphs[key])
                return self._graph[1].replay
            self._graph = None
            if len(self._graphs) >= MAX_GRAPHS:
                del self._graphs[next(iter(self._graphs))]
            (graph,) = capture_graphs([self._epoch], self._warm_up, self._static_tensors(),
                                      self._generators(), self.device)
            profiling.count("fit.captures")
            self._graph = (key, graph)
            self._graphs[key] = graph
            return graph.replay

    # ------------------------------------------------------------ generation
    @torch.no_grad()
    @under_policy
    def generate_samples(self, target_label: int, num: int) -> np.ndarray:
        """Sample `num` rows of class `target_label` from the prior
        (reference `src/cvae_gan.py:339-345`), as float32 numpy."""
        self._require_state()
        labels = self._labels(target_label, num)
        out = self._generator_forward(self.state, self._prior(num), labels)
        return out.to(torch.float32).cpu().numpy()

    @torch.no_grad()
    def generate_samples_fast(self, target_label: int, num: int) -> np.ndarray:
        """Prior sampling through the fused generator kernel
        (`kernels/fused_mlp.py`): eval-mode BatchNorm folded into the
        matmuls, all four layers in one launch. The final activation is
        the generator's own. The kernel and its inputs are float32 under
        either policy. Of a generator `parallel.mesh.place` sliced over
        'model', the leaves are gathered whole first (every model rank
        calls this), as the Pallas call in JAX receives GSPMD-gathered
        operands, and the fold is kept until the state or its placement
        changes. On the card the rows come out block by block into
        page-locked host memory (`_forward_pinned`), which the returned
        array holds until the caller drops it. Only available for the
        standard conditional MLP generator; raises NotImplementedError
        otherwise."""
        with profiling.span("gen.fast", rows=num):
            self._require_state()
            if not self.conditional_sampling:
                raise NotImplementedError(
                    f"{self.name}: the fused kernel serves the conditional generator "
                    "only (its input is concat(z, onehot(y))); use generate_samples()")
            gen = self.state["generator"]
            with profiling.span("gen.draw"):
                labels = self._labels(target_label, num)
                z = self._prior(num)
            final = getattr(gen, "out_activation", None) or "none"
            try:
                with profiling.span("gen.fold") as sp:
                    params, built = self._fast_fold(gen)
                    sp.set(built=built)
                with profiling.span("gen.forward"):
                    onehot = one_hot(labels, self.label_num)
                    if z.is_cuda:
                        out, copied = _forward_pinned(z, onehot, params, final)
                        if profiling.recording():
                            # the span ends with the last block's kernel, so the
                            # copy's span holds the copy that B1 did not hide
                            done = torch.cuda.Event()
                            done.record()
                            done.synchronize()
                    else:
                        out, copied = fused.fast_generator_forward(
                            gen, z, onehot, final=final, params=params), None
            except NotImplementedError as e:
                raise NotImplementedError(
                    f"{self.name}: {e}; use generate_samples()") from e
            with profiling.span("gen.copy", bytes=out.numel() * out.element_size()):
                if copied is not None:
                    copied.synchronize()
                return out.cpu().numpy()

    def _fast_fold(self, gen):
        """(the fast path's folded generator, whether it was built now):
        folded anew each call, unless `parallel.mesh.place` sliced the
        generator, whose fold is gathered once and kept until the state
        or its placement changes."""
        placed = any(mesh_lib.shard_of(t) is not None for t in mesh_lib.state_tensors(gen))
        params = self._gen_cache.get("fast_fold") if placed else None
        if params is not None:
            return params, False
        params = fused.generator_fast_params(gen, whole=mesh_lib.gather_leaf)
        if placed:
            self._gen_cache["fast_fold"] = params
        profiling.count("gen.fold_builds")
        return params, True

    @torch.no_grad()
    @under_policy
    def generate_qualified_samples(
        self, target_label: int, num: int,
        confidence_threshold: Optional[float] = None,
    ) -> np.ndarray:
        """Classifier-filtered generation (reference
        `src/cvae_gan.py:347-378`): keep samples with max softmax prob >
        threshold AND argmax == target_label; give up once a cumulative
        budget of 20 zero-survivor candidate batches is spent (never
        refunded on success). Candidate batches are min(4096, capacity)
        rows. As in the JAX package, which keeps one compiled program per
        capacity, the capacity is the smallest one used since the state
        last changed that is >= num, else the smallest power of two >=
        max(num, 256): the pipeline asks for the largest need first, so
        every class draws batches of that size. A host loop drives one
        candidate batch per iteration on the device."""
        self._require_state()
        if confidence_threshold is None:
            confidence_threshold = self.hparams.get("confidence_threshold", 0.5)
        if num <= 0:
            return np.empty((0, self.feature_num), np.float32)
        caps = self._gen_cache.setdefault("qualified_caps", set())
        fits = [c for c in caps if c >= num]
        if fits:
            cap = min(fits)
        else:
            cap = 256
            while cap < num:
                cap *= 2
            caps.add(cap)
        return self._filtered(target_label, num, confidence_threshold, min(4096, cap),
                              self._prior)

    def _filtered(self, target_label: int, num: int, confidence_threshold: float,
                  cand: int, latents) -> np.ndarray:
        """The confidence filter's loop: candidate batches of `cand` rows
        decoded from `latents(cand)` until `num` rows pass or 20 batches
        have passed none."""
        labels = self._labels(target_label, cand)
        fstate = self._filter_state(self.state)
        kept, count, patience = [], 0, QUALIFIED_PATIENCE
        while count < num and patience > 0:
            x = self._generator_forward(self.state, latents(cand), labels)
            probs = torch.softmax(self._classifier_logits(fstate, x), dim=-1)
            valid = ((probs.amax(dim=-1) > confidence_threshold)
                     & (probs.argmax(dim=-1) == labels))
            rows = x[valid]
            if rows.shape[0] == 0:
                patience -= 1
                continue
            rows = rows[: num - count]
            kept.append(rows)
            count += rows.shape[0]
        if not kept:
            return np.empty((0, self.feature_num), np.float32)
        return torch.cat(kept).to(torch.float32).cpu().numpy()

    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Encode-then-decode round trip (reference
        `src/cvae_gan.py:380-397`). Only meaningful for VAE-family models;
        others raise."""
        raise NotImplementedError(f"{self.name} has no encoder")

    @torch.no_grad()
    @under_policy
    def _reconstruct(self, samples, labels) -> np.ndarray:
        """Encode with reparameterisation, then decode; `labels` is None for
        the unconditional family."""
        self._require_state()
        x = torch.as_tensor(np.asarray(samples, np.float32), device=self.device)
        y = None if labels is None else torch.as_tensor(
            np.asarray(labels, np.int64), device=self.device)
        mu, log_var = apply_eval(self.state["encoder"], x, y)
        z = mlp.reparameterize(mu, log_var, self.generator)
        out, _ = apply_eval(self.state[self.decoder_name], z, y)
        return out.to(torch.float32).cpu().numpy()

    # ---------------------------------------------------------- diagnostics
    def get_feature_importance(self, net: str = "discriminator"):
        """Per-input-feature mean |W| of a network's first dense layer
        (reference `src/models/cvae_gan_models.py:231-247,285-292`): for
        conditional networks (data_importance, condition_importance), for
        the classifier a single vector."""
        from cvaegan_tpu_torch.utils import introspection

        self._require_state()
        if net not in self.state:
            raise KeyError(f"{self.name} has no network {net!r}; "
                           f"available: {sorted(self.state.keys())}")
        if net == "classifier":
            return introspection.first_layer_importance(self.state[net])
        return introspection.split_importance(self.state[net], self.feature_num)

    def plot_loss_history(self):
        """Per-loss curves + a combined plot saved under gan_outs
        (reference `src/cvae_gan.py:263-337`). Needs matplotlib."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        keys = [k for k in self.loss_keys if self.loss_history.get(k)]
        if not keys:
            return None
        rows = (len(keys) + 1) // 2
        plt.figure(figsize=(12, 4 * rows))
        for i, k in enumerate(keys):
            plt.subplot(rows, 2, i + 1)
            plt.plot(self.loss_history[k])
            plt.xlabel("Epoch")
            plt.ylabel("Loss")
            plt.title(k)
        plt.tight_layout()
        out = self.settings.paths.gan_outs / f"{self.name}_loss_history.jpg"
        plt.savefig(out)
        plt.close()

        plt.figure(figsize=(12, 6))
        for k in keys:
            vals = self.loss_history[k]
            if k == "adv_loss":
                plt.plot([abs(v) for v in vals], label=f"{k} (abs)")
            else:
                plt.plot(vals, label=k)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.title(f"{self.name} loss history")
        plt.legend()
        plt.grid(True, alpha=0.3)
        out2 = self.settings.paths.gan_outs / f"{self.name}_combined_loss.jpg"
        plt.savefig(out2)
        plt.close()
        print(f"loss curves saved to {out} and {out2}")
        return out


class UnconditionalTrainer(GenerativeTrainer):
    """The unconditional family (GAN, VAE, VAE-GAN): one round per epoch on
    uniform batches over the whole train set, a decoder (`decoder_name`)
    that takes z alone, and `generate_samples(num)` without a label
    (reference `src/gan.py`, `src/vae.py`, `src/vae_gan.py`).
    `generate_qualified_samples(label, num)` filters the decoder's output
    through the auxiliary classifier, where there is one."""

    conditional_sampling = False

    def _class_rounds(self) -> List[Optional[int]]:
        return [None]

    def _generator_forward(self, state, z, labels):
        x, _ = apply_eval(state[self.decoder_name], z)
        return x

    @torch.no_grad()
    @under_policy
    def generate_samples(self, num: int) -> np.ndarray:  # type: ignore[override]
        """Sample `num` rows from the prior (reference
        `src/gan.py:generate_samples`), as float32 numpy."""
        self._require_state()
        out = self._generator_forward(self.state, self._prior(num), None)
        return out.to(torch.float32).cpu().numpy()
