"""Downstream evaluation classifier, the counterpart of
`cvaegan_tpu/eval/classifier.py`.

Capability parity with reference `src/classifier.py:11-303`: fit /
predict / test / binary_test / print_metrics / plot_roc_curve, macro
P/R/F1 + per-class classification report + confusion matrix. The
metrics are computed with numpy here, as sklearn computes them
(`precision_recall_fscore_support` with `zero_division=0`,
`confusion_matrix`, `classification_report(output_dict=True)`), so
nothing on the card needs sklearn.

Training: the JAX package scans every epoch's batch steps in one XLA
program. On CUDA the port captures the step as CUDA graphs: a block of
`BLOCK_STEPS` steps and a single step, each reading its batch's rows
from a permutation on the device at a batch counter on the device and
advancing the counter. An epoch draws its permutation outside the graphs
into a static buffer, zeroes the counter and replays the block, then the
single step, until it has run ceil(rows / batch) steps, as JAX's epoch
does. The generator that draws the permutations and the dropout masks is
registered with both graphs. `fit` and `fit_streamed` share this; with
`eager=True`, inside `utils.profiling.nan_debug()` and on the CPU the
same step runs op by op (the plain version).

The scripts' warm-start idiom `clf.model = gan.classifier` becomes
`clf.warm_start_from(trainer)`, which adopts a deep copy of the trainer's
companion classifier: a JAX array is immutable, so the JAX downstream fit
leaves the trainer's classifier (the qualified-sample filter) as it was,
and a copy keeps that true here.
"""

from __future__ import annotations

import copy
import itertools
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import (Adam, apply_eval, capture_graphs, init_net,
                                          resolve_device)
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.models import mlp
from cvaegan_tpu_torch.models.layers import dtype_override, forward_with
from cvaegan_tpu_torch.utils.logger import Logger
from cvaegan_tpu_torch.utils.profiling import nan_debug_active


def _train_arrays(dataset):
    if isinstance(dataset, TabularDataset):
        return dataset.tr_samples, dataset.tr_labels
    x, y = dataset.as_tuple() if hasattr(dataset, "as_tuple") else dataset
    return np.asarray(x, np.float32), np.asarray(y, np.int32)


def _test_arrays(dataset):
    if isinstance(dataset, TabularDataset):
        return dataset.te_samples, dataset.te_labels
    x, y = dataset.as_tuple() if hasattr(dataset, "as_tuple") else dataset
    return np.asarray(x, np.float32), np.asarray(y, np.int32)


def _labels_of(y: np.ndarray) -> np.ndarray:
    """Integer labels of a one-hot or one-column y chunk."""
    return (y.argmax(axis=1) if y.shape[1] > 1 else y[:, 0]).astype(np.int32)


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den with 0 where den is 0 (sklearn's zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def classification_metrics(real, pred, labels: Optional[Sequence[int]] = None):
    """(confusion matrix, macro {Precision, Recall, F1}, report dict), as
    sklearn's `confusion_matrix(labels=labels)`, `precision_score` etc.
    with `average="macro", zero_division=0` (over the labels present in
    either vector) and `classification_report(labels=labels,
    output_dict=True, zero_division=0)` give them."""
    real, pred = np.asarray(real).astype(np.int64), np.asarray(pred).astype(np.int64)
    present = np.union1d(real, pred)
    rep_labels = present if labels is None else np.asarray(list(labels), np.int64)

    def stats(lbls):
        tp = np.array([np.sum((real == c) & (pred == c)) for c in lbls])
        n_pred = np.array([np.sum(pred == c) for c in lbls])
        support = np.array([np.sum(real == c) for c in lbls])
        precision = _ratio(tp, n_pred)
        recall = _ratio(tp, support)
        f1 = _ratio(2 * tp, n_pred + support)
        return precision, recall, f1, support

    confusion = np.array([[np.sum((real == a) & (pred == b)) for b in rep_labels]
                          for a in rep_labels], dtype=np.int64)
    p, r, f, _ = stats(present)
    macro = {"Precision": float(p.mean()), "Recall": float(r.mean()),
             "F1": float(f.mean())}

    p, r, f, s = stats(rep_labels)
    report = {str(int(c)): {"precision": float(p[i]), "recall": float(r[i]),
                            "f1-score": float(f[i]), "support": int(s[i])}
              for i, c in enumerate(rep_labels)}
    total = int(s.sum())
    if set(present.tolist()) <= set(rep_labels.tolist()):
        report["accuracy"] = float(np.mean(real == pred))
    else:
        tp_all = float(sum(np.sum((real == c) & (pred == c)) for c in rep_labels))
        n_pred_all = float(sum(np.sum(pred == c) for c in rep_labels))
        mp, mr = float(_ratio(tp_all, n_pred_all)), float(_ratio(tp_all, total))
        report["micro avg"] = {"precision": mp, "recall": mr,
                               "f1-score": float(_ratio(2 * tp_all, n_pred_all + total)),
                               "support": total}
    report["macro avg"] = {"precision": float(p.mean()), "recall": float(r.mean()),
                           "f1-score": float(f.mean()), "support": total}
    w = s / total if total else np.zeros_like(s, np.float64)
    report["weighted avg"] = {"precision": float(np.sum(p * w)),
                              "recall": float(np.sum(r * w)),
                              "f1-score": float(np.sum(f * w)), "support": total}
    return confusion, macro, report


class Classifier:
    #: rows per inference call of `predict`
    PREDICT_CHUNK = 65536
    #: optimizer steps of the captured block of an epoch on CUDA
    BLOCK_STEPS = 128

    def __init__(self, name: str, seed: Optional[int] = None,
                 settings: Optional[config_lib.Settings] = None, device="cuda"):
        self.settings = settings or config_lib.settings
        self.cfg = self.settings.classifier
        self.name = f"{name}_classifier"
        self.logger = Logger(name)
        self.device = resolve_device(device)
        self.seed = (self.settings.seed if seed is None else seed) + 1
        #: draws every permutation and dropout mask of `fit`
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.module: Optional[torch.nn.Module] = None
        self.label_num: int = 0
        self.confusion_matrix: Optional[np.ndarray] = None
        self.metrics: Dict[str, float] = {"Precision": 0.0, "Recall": 0.0, "F1": 0.0}
        self.class_metrics = None
        #: host-clock seconds of the last `fit` or `fit_streamed`
        self.fit_seconds: Optional[float] = None
        #: the tensors an epoch reads: the rows `x`, `y` and their
        #: `weights`, the epoch's padded permutation `perm` and its rows'
        #: weights `perm_weights`, the batch counter `batch`
        self._window: Optional[Dict[str, torch.Tensor]] = None
        #: (key, {"block": CUDAGraph or None, "step": CUDAGraph})
        self._graphs = None

    def _ensure_built(self, feature_num: int, label_num: int) -> None:
        if self.module is None:
            self.label_num = label_num
            self.module = init_net(mlp.Classifier(feature_num, label_num),
                                   torch.Generator().manual_seed(self.seed),
                                   self.device)
            self._graphs = None

    def warm_start_from(self, trainer) -> None:
        """Adopt a deep copy of a trainer's companion classifier, buffers
        included (reference warm start `clf.model = gan.classifier`,
        `scripts/train_cvae_gan.py:144-145`). Any companion will do: its
        forward gets the generator only if it drops out (`forward_with`),
        a tuple output gives its logits first (RAIN-GAN's), and its
        spectral u/v or BatchNorm statistics update in train mode, as the
        JAX package commits a companion's mutables."""
        self.module = copy.deepcopy(trainer.state["classifier"]).to(self.device)
        self.label_num = trainer.label_num
        self._graphs = None

    # -------------------------------------------------------------- train
    def fit(self, dataset, eager: bool = False) -> None:
        """`settings.classifier.epochs` epochs of Adam (lr 1e-3, betas
        0.9/0.999) over batches of `batch_size` rows in a fresh permutation
        each epoch; the tail batch is filled with the permutation's first
        rows at weight 0 under the weighted cross entropy
        (`eval/classifier.py:136-186` of the JAX package). Captured on
        CUDA unless `eager=True`."""
        x, y = _train_arrays(dataset)
        self._ensure_built(x.shape[1], int(y.max()) + 1)
        self.logger.info("Started training")
        t0 = time.perf_counter()
        self._fit_arrays(x, y, self.cfg.epochs, self._new_optimizer(), eager=eager)
        self._sync()
        self.fit_seconds = time.perf_counter() - t0
        self.logger.info("Finished training")

    def _new_optimizer(self) -> Adam:
        return Adam(list(self.module.parameters()), self.cfg.lr)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit_streamed(self, x_csv, y_csv, window_rows: int = 1_000_000,
                     epochs_per_window: int = 10, transform=None,
                     eager: bool = False) -> int:
        """Out-of-core downstream training over an (x, y) CSV pair, as the
        JAX package's (`cvaegan_tpu/eval/classifier.py:231-290`): windows
        of `window_rows` rows, each trained for `epochs_per_window` epochs
        with the network and one Adam kept across windows. A short window
        is padded to `window_rows` with its own rows at weight 0, so every
        window has the shapes of the first, is copied into the tensors the
        captured epoch reads, and replays the same graphs.
        `transform(chunk)` scales each window's features; y is one-hot or
        one integer column. Returns the number of windows."""
        from cvaegan_tpu_torch.data.streaming import StreamingCSV

        self.logger.info("Started streamed training")
        t0 = time.perf_counter()
        opt = None
        n_windows = 0
        end = object()
        for xw, yw in itertools.zip_longest(StreamingCSV(x_csv, window_rows),
                                            StreamingCSV(y_csv, window_rows), fillvalue=end):
            if xw is end or yw is end or len(xw) != len(yw):
                raise ValueError(f"x/y row mismatch at window {n_windows} — "
                                 "misaligned CSV pair")
            if transform is not None:
                xw = transform(xw)
            labels = _labels_of(yw)
            if self.module is None and n_windows == 0:
                label_num = int(yw.shape[1]) if yw.shape[1] > 1 else int(labels.max()) + 1
                self._ensure_built(int(xw.shape[1]), label_num)
            if labels.size and (labels.min() < 0 or labels.max() >= self.label_num):
                raise ValueError(f"window {n_windows} holds class id {int(labels.max())} "
                                 f"outside the model's {self.label_num} classes")
            n = len(xw)
            weights = np.ones(window_rows, np.float32)
            if n < window_rows:
                # Real rows repeated, not zero rows: they keep the batch
                # statistics of a warm-started BatchNorm classifier (CTGAN's)
                # realistic in a mostly padded last window.
                reps = np.arange(window_rows - n) % n
                xw = np.concatenate([xw, xw[reps]])
                labels = np.concatenate([labels, labels[reps]])
                weights[n:] = 0.0
            if opt is None:
                opt = self._new_optimizer()
            self._fit_arrays(xw, labels, epochs_per_window, opt, weights=weights, eager=eager)
            n_windows += 1
        if n_windows == 0:
            raise ValueError(f"empty corpus: {x_csv}")
        self._sync()
        self.fit_seconds = time.perf_counter() - t0
        self.logger.info("Finished streamed training")
        return n_windows

    @dtype_override(torch.float32)
    def _fit_arrays(self, x, y, epochs: int, opt: Adam, weights=None,
                    eager: bool = False) -> None:
        """`epochs` epochs over one array pair with per-row `weights`
        (default 1), continuing `opt`. Float32 whatever the compute policy
        (the captures included), as the JAX package pins its classifier
        (`cvaegan_tpu/eval/classifier.py:217-223`): the instrument does not
        move with the models it measures."""
        self._load_window(np.asarray(x, np.float32), np.asarray(y), weights)
        w, bs = self._window, self.cfg.batch_size
        n = w["x"].shape[0]
        nb = w["perm"].shape[0] // bs
        pad = nb * bs - n
        zeros = torch.zeros(pad, device=self.device)
        tail = torch.arange(pad, device=self.device) % n  # the first rows again
        self.module.train()
        captured = not (eager or self.device.type != "cuda" or nan_debug_active())
        graphs = self._captured(opt) if captured else None
        for _ in range(epochs):
            perm = torch.randperm(n, generator=self.generator, device=self.device)
            with torch.no_grad():
                w["perm"].copy_(torch.cat([perm, perm[tail]]))
                w["perm_weights"].copy_(torch.cat([w["weights"][perm], zeros]))
                w["batch"].zero_()
            if graphs is None:
                for _ in range(nb):
                    self._indexed_step(opt)
                continue
            for _ in range(nb // self.BLOCK_STEPS):
                graphs["block"].replay()
            for _ in range(nb % self.BLOCK_STEPS):
                graphs["step"].replay()

    def _load_window(self, x: np.ndarray, y: np.ndarray, weights) -> None:
        """Copy the rows into the tensors an epoch reads: in place where the
        shapes match (the captured steps stay valid), else into new tensors
        (the captures go)."""
        n, bs = len(x), self.cfg.batch_size
        weights = np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32)
        w = self._window
        if w is not None and w["x"].shape == x.shape and w["perm"].shape[0] == -(-n // bs) * bs:
            with torch.no_grad():
                w["x"].copy_(torch.from_numpy(x))
                w["y"].copy_(torch.from_numpy(y.astype(np.int64)))
                w["weights"].copy_(torch.from_numpy(weights))
            return
        dev = self.device
        self._window = {
            "x": torch.as_tensor(x, device=dev),
            "y": torch.as_tensor(y.astype(np.int64), device=dev),
            "weights": torch.as_tensor(weights, device=dev),
            "perm": torch.zeros(-(-n // bs) * bs, dtype=torch.int64, device=dev),
            "perm_weights": torch.zeros(-(-n // bs) * bs, device=dev),
            "batch": torch.zeros(1, dtype=torch.int64, device=dev),
        }
        self._graphs = None

    def _indexed_step(self, opt: Adam) -> None:
        """One optimizer step on the batch at the device counter, which it
        advances: its rows and weights from the epoch's permutation."""
        w, bs = self._window, self.cfg.batch_size
        rows = w["perm"].view(-1, bs).index_select(0, w["batch"]).view(bs)
        bw = w["perm_weights"].view(-1, bs).index_select(0, w["batch"]).view(bs)
        self._step(opt, w["x"][rows], w["y"][rows], bw)
        with torch.no_grad():
            w["batch"].add_(1)

    def _step(self, opt: Adam, bx, by, bw) -> torch.Tensor:
        """One optimizer step on a batch with per-row weights."""
        out = forward_with(self.module, bx, generator=self.generator)
        logits = out[0] if isinstance(out, tuple) else out
        loss = losses.weighted_cross_entropy(logits, by, bw)
        opt.step(torch.autograd.grad(loss, opt.params))
        return loss.detach()

    def _captured(self, opt: Adam) -> Dict[str, Optional[torch.cuda.CUDAGraph]]:
        """The captured block of `BLOCK_STEPS` steps (None where an epoch
        has fewer steps) and single step for this network, optimizer and
        window, capturing them unless they exist. A warm-up step runs on
        the capture stream first; its effects on the network, the
        optimizer, the counter and the generator are undone."""
        w = self._window
        key = (id(self.module), id(opt), id(w["x"]), self.cfg.batch_size, self.BLOCK_STEPS)
        if self._graphs is not None and self._graphs[0] == key:
            return self._graphs[1]
        self._graphs = None
        nb = w["perm"].shape[0] // self.cfg.batch_size

        def steps(n):
            def body():
                for _ in range(n):
                    self._indexed_step(opt)
            return body

        static = [*self.module.state_dict(keep_vars=True).values(), *opt.tensors(), w["batch"]]
        bodies = [steps(1)] if nb < self.BLOCK_STEPS else [steps(1), steps(self.BLOCK_STEPS)]
        captured = capture_graphs(bodies, steps(1), static, [self.generator], self.device)
        graphs = {"step": captured[0], "block": captured[1] if len(captured) > 1 else None}
        self._graphs = (key, graphs)
        return graphs

    # ------------------------------------------------------------ predict
    @dtype_override(torch.float32)
    def _logits(self, x: np.ndarray) -> np.ndarray:
        outs = []
        for i in range(0, len(x), self.PREDICT_CHUNK):
            part = torch.as_tensor(np.asarray(x[i:i + self.PREDICT_CHUNK], np.float32),
                                   device=self.device)
            out = apply_eval(self.module, part)
            outs.append((out[0] if isinstance(out, tuple) else out).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def predict(self, x, use_prob: bool = False) -> np.ndarray:
        logits = self._logits(np.asarray(x, np.float32))
        if use_prob:
            return logits
        return np.argmax(logits, axis=1)

    def predict_stream(self, chunks, use_prob: bool = False) -> np.ndarray:
        """`predict` over an iterable of `[rows, features]` chunks (a
        `StreamingCSV`, say) without holding the features in memory: only
        the predictions accumulate. Equal to `predict` of the
        concatenation."""
        outs = [self.predict(chunk, use_prob=use_prob) for chunk in chunks]
        if not outs:
            raise ValueError("predict_stream: empty chunk iterable")
        return np.concatenate(outs, axis=0)

    def get_feature_importance(self):
        """Mean |W| of the first dense layer per input feature (reference
        `src/models/cvae_gan_models.py:285-292`)."""
        from cvaegan_tpu_torch.utils.introspection import first_layer_importance

        if self.module is None:
            raise RuntimeError("call fit() first")
        return first_layer_importance(self.module)

    # --------------------------------------------------------------- test
    def _compute_metrics(self, real, pred, labels=None) -> None:
        self.confusion_matrix, self.metrics, self.class_metrics = \
            classification_metrics(real, pred, labels)

    def test(self, dataset) -> None:
        """Multiclass macro P/R/F1 + per-class report (`src/classifier.py:56-106`)."""
        x, y = _test_arrays(dataset)
        self._compute_metrics(y, self.predict(x), labels=list(range(self.label_num)))

    def binary_test(self, dataset) -> None:
        """Same, with labels > 0 squashed to 1 (`src/classifier.py:108-161`)."""
        x, y = _test_arrays(dataset)
        pred = (self.predict(x) > 0).astype(np.int32)
        self._compute_metrics((np.asarray(y) > 0).astype(np.int32), pred)

    def test_streamed(self, x_csv, y_csv, chunk_rows: int = 262_144,
                      binary: bool = False, transform=None) -> None:
        """`test` (or `binary_test`) over an (x, y) CSV pair streamed in
        chunks of `chunk_rows`: only the integer predictions and labels
        accumulate. `transform(chunk)` applies the training-time feature
        scaling; y is one-hot or one integer column."""
        from cvaegan_tpu_torch.data.streaming import StreamingCSV

        preds, reals = [], []
        end = object()
        for i, (xw, yw) in enumerate(itertools.zip_longest(
                StreamingCSV(x_csv, chunk_rows), StreamingCSV(y_csv, chunk_rows),
                fillvalue=end)):
            if xw is end or yw is end or len(xw) != len(yw):
                raise ValueError(f"x/y row mismatch at chunk {i} — misaligned CSV pair")
            if transform is not None:
                xw = transform(xw)
            preds.append(self.predict(xw))
            reals.append(_labels_of(yw))
        if not preds:
            raise ValueError(f"empty corpus: {x_csv}")
        pred, real = np.concatenate(preds), np.concatenate(reals)
        if binary:
            self._compute_metrics((real > 0).astype(np.int32), (pred > 0).astype(np.int32))
        else:
            self._compute_metrics(real, pred, labels=list(range(self.label_num)))

    # ------------------------------------------------------------ reports
    def print_metrics(self, decimals: int = 4, print_class_metrics: bool = True):
        """Formatted metric dump (`src/classifier.py:163-208`)."""
        print("Overall metrics:")
        print({k: round(v, decimals) for k, v in self.metrics.items()})
        if not (print_class_metrics and self.class_metrics is not None):
            return

        def block(title, v):
            print(f"\n{title}:")
            print(f"  Precision: {round(v['precision'], decimals)}")
            print(f"  Recall: {round(v['recall'], decimals)}")
            print(f"  F1-Score: {round(v['f1-score'], decimals)}")
            print(f"  Support: {v['support']}")

        print("\nPer-class metrics:")
        for key, value in self.class_metrics.items():
            if key.isdigit():
                block(f"class {int(key)}", value)
        for avg in ("macro avg", "weighted avg"):
            if avg in self.class_metrics:
                block(avg, self.class_metrics[avg])
        if "accuracy" in self.class_metrics:
            print(f"\nAccuracy: {round(self.class_metrics['accuracy'], decimals)}")

    def plot_roc_curve(self, dataset, is_binary: bool = False):
        """OvR multiclass or binary ROC/AUC jpg (`src/classifier.py:210-303`);
        scores are raw logits. Needs matplotlib and sklearn."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn import metrics as skm

        x, y = _test_arrays(dataset)
        logits = self._logits(x)
        plt.figure(figsize=(10, 8))
        if not is_binary and logits.shape[1] > 2:
            colors = ["aqua", "darkorange", "cornflowerblue", "green", "red", "purple"]
            for i in range(self.label_num):
                target = (np.asarray(y) == i).astype(np.int32)
                fpr, tpr, _ = skm.roc_curve(target, logits[:, i])
                auc = skm.roc_auc_score(target, logits[:, i])
                plt.plot(fpr, tpr, color=colors[i % len(colors)], lw=2,
                         label=f"ROC curve of class {i} (area = {auc:0.2f})")
        else:
            score = logits[:, 1] if logits.shape[1] > 1 else logits[:, 0]
            y_test = np.where(np.asarray(y) > 0, 1, 0)
            fpr, tpr, _ = skm.roc_curve(y_test, score)
            auc = skm.roc_auc_score(y_test, score)
            plt.plot(fpr, tpr, color="darkorange", lw=2,
                     label=f"ROC curve (area = {auc:0.2f})")
        plt.plot([0, 1], [0, 1], color="navy", lw=2, linestyle="--")
        plt.xlim([0.0, 1.0])
        plt.ylim([0.0, 1.05])
        plt.xlabel("False Positive Rate")
        plt.ylabel("True Positive Rate")
        plt.title(f"{self.name} Receiver Operating Characteristic (ROC) Curve")
        plt.legend(loc="lower right")
        plt.grid(True, alpha=0.3)
        model_name = self.name.replace("_classifier", "")
        suffix = "binary" if is_binary else "multiclass"
        out = self.settings.paths.gan_outs / f"{model_name}_roc_curve_{suffix}.jpg"
        plt.savefig(out)
        plt.close()
        print(f"ROC curve saved to {out}")
        return out
