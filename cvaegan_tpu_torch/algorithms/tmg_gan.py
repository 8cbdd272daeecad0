"""TMG-GAN, the Targeted Multi-Generator GAN, the counterpart of
`cvaegan_tpu/algorithms/tmg_gan.py`.

Capability parity with reference `src/tmg_gan.py` + `src/models/
tmg_gan_models.py`:
  * one generator per class and a shared CD network with critic and
    softmax-classifier heads over a common trunk (`src/tmg_gan.py:13-20`);
  * per class per epoch: CD x5 on `(E[D(G)] - E[D(x)]) / 2 + CE`
    (`:61-86`), G x3 on `-E[D(G)] + CE - cos(hidden_real, hidden_fake)`,
    the cosine term off before epoch 1000 (`:89-119`);
  * one cross-generator diversity step per epoch: every generator emits 3
    samples, and the mean pairwise cosine similarity of their trunk hidden
    states, divided by feature_num, is backpropagated through all
    generators (`:120-146`), absent classes' included;
  * a scatter of 10 generated rows per class every 10 epochs into
    `gan_outs/tmg_<e>.jpg` (`:149-177`);
  * qualified sampling by CD argmax with patience 10, which falls back to
    arbitrary rows, so that it always returns exactly `num` rows
    (`:234-263`).

The generators are an `nn.ModuleList` (`state["gens"]`), each with its own
Adam (`optimizers["gens.{i}"]`) and so its own device step count: a
class's G step advances its generator's, the diversity step every one's.
The JAX package stacks their parameters and vmaps one module and one
Adam over them. As there, the CD head's softmax probabilities go into
the standard cross entropy (a reference quirk, kept), and `balanced_mode`
is refused: the training is per class by construction. Each step takes
its random inputs from the caller, which draws them from the trainer's
generator, so the epoch is captured as one CUDA graph.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer, under_policy
from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import (
    Adam,
    _total,
    adam,
    apply_eval,
    apply_train,
    grad_update,
    init_net,
    replicated_gradients,
)
from cvaegan_tpu_torch.models.layers import widened
from cvaegan_tpu_torch.models.tmg import TMGCD, TMGGenerator

#: samples per generator in the diversity step (`src/tmg_gan.py:120-146`)
DIVERSITY_ROWS = 3
#: the G step's cosine term is off before this epoch (`src/tmg_gan.py:89-119`)
COSINE_EPOCH = 1000
#: empty candidate batches before qualified sampling takes arbitrary rows
QUALIFIED_PATIENCE = 10
#: rows per class in each chunk-end scatter
SNAPSHOT_ROWS = 10


class TMGGAN(GenerativeTrainer):
    name = "tmg_gan"
    config_key = "tmg_gan"
    loss_keys = ("d_loss", "g_loss")
    loops = ("c", "g")
    #: the reference saves a scatter every 10 epochs (`src/tmg_gan.py:149`):
    #: the chunk hook runs at exactly those boundaries
    epoch_chunk = 10
    _jax_dims = staticmethod(convert.tmg_gan_dims)
    _state_from_jax = staticmethod(convert.tmg_gan_state_from_jax)
    #: whether a hook has already said that matplotlib is missing
    _said_no_plot = False

    def __init__(self, seed: Optional[int] = None,
                 settings: Optional[config_lib.Settings] = None,
                 device="cuda", balanced_mode: bool = False):
        if balanced_mode:
            raise ValueError(
                "TMG-GAN has one generator per class: its training is "
                "per class by construction, so balanced_mode does not apply")
        super().__init__(seed=seed, settings=settings, device=device)
        #: draws the chunk-end scatters, apart from the training stream
        self._snapshot_generator = torch.Generator(device=self.device).manual_seed(self.seed)

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        cd = init_net(TMGCD(self.feature_num, self.label_num), init_generator, self.device)
        gens = nn.ModuleList(
            init_net(TMGGenerator(self.gan_cfg.z_size, self.feature_num), init_generator,
                     self.device) for _ in range(self.label_num))
        return {"cd": cd, "gens": gens}

    def _build_optimizers(self, nets: Dict[str, nn.Module]) -> Dict[str, Adam]:
        """CD's Adam at `c_lr`, and one Adam at `g_lr` per generator."""
        cfg = self.gan_cfg
        opts = {"cd": adam(nets["cd"], cfg.c_lr, cfg.adam_b1, cfg.adam_b2)}
        for i, gen in enumerate(nets["gens"]):
            opts[f"gens.{i}"] = adam(gen, cfg.g_lr, cfg.adam_b1, cfg.adam_b2)
        return opts

    # ------------------------------------------------------------- steps
    def _cd_step(self, x_real, y, z, class_id: int) -> torch.Tensor:
        """CD update on `(E[D(G)] - E[D(x)]) / 2 + CE(softmax probs of the
        real rows)` (`src/tmg_gan.py:61-86`): the class's generator runs in
        train mode under no-grad (its BatchNorm statistics commit), then CD
        on concat(real, fake) with dropout and one power iteration.
        Returns the critic part."""
        x_fake, _ = apply_train(self.state["gens"][class_id], z)
        cd = self.state["cd"].train()

        def loss_fn():
            scores, probs, _ = cd(torch.cat([x_real, x_fake], dim=-2), self.generator)
            s_real, s_fake = widened(scores).chunk(2, dim=-2)
            d_loss = (s_fake.mean((-2, -1)) - s_real.mean((-2, -1))) / 2.0
            # CE over softmax outputs: the reference's quirk, kept.
            real_probs = probs[..., : x_real.shape[-2], :]
            return d_loss + losses.cross_entropy(real_probs, y), d_loss

        _, d_loss = grad_update(self.optimizers["cd"], loss_fn)
        return d_loss.detach()

    def _g_step(self, x_real, y, z, class_id: int, epoch: torch.Tensor) -> torch.Tensor:
        """The class's generator update (`src/tmg_gan.py:89-119`): CD runs
        in train mode on the real rows, then on the fakes, its u/v updating
        in each (so the second sees the first's); loss `-E[D(G)] +
        CE(probs_fake) - gate cos(hidden_real, hidden_fake)`, gate 0 before
        COSINE_EPOCH, read from the device epoch, so one graph serves both
        sides of it. Only the generator is stepped."""
        gen = self.state["gens"][class_id].train()
        cd = self.state["cd"].train()
        gate = (epoch >= COSINE_EPOCH).to(torch.float32)

        def loss_fn():
            x_fake, _ = gen(z)
            _, _, hidden_real = cd(x_real, self.generator)
            s_fake, probs_fake, hidden_fake = cd(x_fake, self.generator)
            loss = (-widened(s_fake).mean((-2, -1)) + losses.cross_entropy(probs_fake, y)
                    - gate * losses.cosine_similarity(hidden_real, hidden_fake))
            return loss, None

        loss, _ = grad_update(self.optimizers[f"gens.{class_id}"], loss_fn)
        return loss.detach()

    def _diversity_step(self, z: torch.Tensor) -> torch.Tensor:
        """Cross-generator decorrelation (`src/tmg_gan.py:120-146`): each
        generator i runs in train mode on its own rows `z[..., i, :, :]`
        `[3, z_size]` (BatchNorm over those 3 rows, its statistics
        committed); the loss is the mean over ordered pairs i != j of the
        row-wise cosine of their hidden states, row k against row k,
        divided by feature_num; one Adam step per generator. The z are
        not sharded under a mesh, as in the JAX package: every rank
        computes the whole step (`replicated_gradients`). A seed bank's
        `z` is `[K, L, 3, z_size]`: each replica's loss is its own."""
        gens = self.state["gens"].train()
        opts = [self.optimizers[f"gens.{i}"] for i in range(len(gens))]
        hidden = torch.stack([gen(z.select(-3, i))[1] for i, gen in enumerate(gens)],
                             dim=-3)
        hidden = widened(hidden)  # as JAX's `hidden.astype(jnp.float32)`
        hn = hidden / (torch.linalg.vector_norm(hidden, dim=-1, keepdim=True) + 1e-8)
        cos = torch.einsum("...ikd,...jkd->...ijk", hn, hn).mean(-1)
        n = len(gens)
        mask = 1.0 - torch.eye(n, device=hidden.device)
        loss = (cos * mask).sum((-2, -1)) / max(n * (n - 1), 1) / self.feature_num
        # the heads do not reach the hidden states: their gradient is 0,
        # and Adam still steps them, as optax does
        grads = replicated_gradients(torch.autograd.grad(
            _total(loss), [p for opt in opts for p in opt.params],
            allow_unused=True, materialize_grads=True))
        start = 0
        for opt in opts:
            opt.step(grads[start:start + len(opt.params)])
            start += len(opt.params)
        return loss.detach()

    # ------------------------------------------------------------- epoch
    def _round(self, class_id: Optional[int], epoch, counts):
        """CD, then G steps on the class (`tmg_gan.py:249-258` of the JAX
        package); the losses are the last CD and G steps'."""
        for _ in range(counts["c"]):
            d_loss = self._cd_step(*self._sample_batch(class_id), self._z_batch(), class_id)
        for _ in range(counts["g"]):
            g_loss = self._g_step(*self._sample_batch(class_id), self._z_batch(), class_id,
                                  epoch)
        return {"d_loss": d_loss, "g_loss": g_loss}

    def _diversity_z(self) -> torch.Tensor:
        return self._normal((self.label_num, DIVERSITY_ROWS, self.gan_cfg.z_size))

    def _epoch_body(self, epoch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The class rounds, then one diversity step over every generator
        (`tmg_gan.py:260-272` of the JAX package)."""
        out = super()._epoch_body(epoch)
        self._diversity_step(self._diversity_z())
        return out

    def _warm_up(self) -> None:
        super()._warm_up()
        self._diversity_step(self._diversity_z())

    def _steps_per_epoch(self) -> int:
        return super()._steps_per_epoch() + 1

    def _on_chunk_end(self, epochs_done: int) -> None:
        """Scatter of SNAPSHOT_ROWS eval-mode samples per class into
        `gan_outs/tmg_<epochs_done>.jpg`, the reference's epoch-mod-10
        diagnostic (`src/tmg_gan.py:149-177`). The z come from a generator
        of the hook's own, so training draws the same stream with or
        without it. Where matplotlib is missing, the samples are drawn and
        one printed line says, once, that no image is written."""
        if self.feature_num < 2:
            return
        samples = []
        with torch.no_grad():
            for c in range(self.label_num):
                z = torch.randn((SNAPSHOT_ROWS, self.gan_cfg.z_size),
                                generator=self._snapshot_generator, device=self.device)
                x = self._generator_forward(self.state, z, self._labels(c, SNAPSHOT_ROWS))
                samples.append(x.to(torch.float32).cpu().numpy())
        try:
            import matplotlib
        except ImportError:
            if not TMGGAN._said_no_plot:
                TMGGAN._said_no_plot = True
                print("tmg_gan: matplotlib is not installed, so the chunk-end "
                      "scatters (tmg_<epoch>.jpg) are not written")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 8))
        for i, s in enumerate(samples):
            plt.scatter(s[:, 0], s[:, 1], label=f"Class {i}", alpha=0.6)
        plt.title(f"TMG-GAN Generated Samples (Epoch {epochs_done})")
        plt.xlabel("Feature 0")
        plt.ylabel("Feature 1")
        plt.legend()
        plt.grid(True, alpha=0.3)
        plt.savefig(self.settings.paths.gan_outs / f"tmg_{epochs_done}.jpg")
        plt.close()

    # --------------------------------------------------------- generation
    def _generator_forward(self, state, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Each row through its own label's generator, in eval mode: every
        generator runs on all rows (eval mode couples no rows), and each
        row is taken from its label's output (`src/tmg_gan.py:296-311`)."""
        x_all = torch.stack([apply_eval(gen, z)[0] for gen in state["gens"]])
        return x_all[labels.long(), torch.arange(z.shape[0], device=z.device)]

    def _classifier_logits(self, state, x: torch.Tensor) -> torch.Tensor:
        """CD's softmax class probabilities, in eval mode."""
        _, probs, _ = apply_eval(state["cd"], x)
        return probs

    @torch.no_grad()
    @under_policy
    def generate_qualified_samples(self, target_label: int, num: int) -> np.ndarray:
        """Rows whose CD argmax is the class, from candidate batches of the
        smallest power of two >= min(4096, 2 num), at least 256 and never
        less than since the state last changed; after QUALIFIED_PATIENCE
        batches in a row without one, a batch's first rows are taken as
        they are. Returns exactly `num` rows (`src/tmg_gan.py:234-263`)."""
        self._require_state()
        if num <= 0:
            return np.zeros((0, self.feature_num), np.float32)
        cand = 256
        while cand < min(4096, 2 * num):
            cand *= 2
        cand = self._gen_cache["qualified_cand"] = max(
            cand, self._gen_cache.get("qualified_cand", 0))
        labels = self._labels(target_label, cand)
        kept, count, empty = [], 0, 0
        while count < num:
            x = self._generator_forward(self.state, self._prior(cand), labels)
            rows = x[self._classifier_logits(self.state, x).argmax(dim=-1) == labels]
            if rows.shape[0] == 0:
                empty += 1
                if empty < QUALIFIED_PATIENCE:
                    continue
                rows = x  # patience spent: take arbitrary rows
            empty = 0
            rows = rows[: num - count]
            kept.append(rows)
            count += rows.shape[0]
        return torch.cat(kept).to(torch.float32).cpu().numpy()

    def generate_samples_fast(self, target_label: int, num: int) -> np.ndarray:
        raise NotImplementedError(
            f"{self.name}: the fused kernel serves the conditional MLP generator "
            "(its input is concat(z, onehot(y))); TMG-GAN's per-class generators "
            "take z alone; use generate_samples()")
