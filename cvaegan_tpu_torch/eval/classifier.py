"""Downstream evaluation classifier, the counterpart of
`cvaegan_tpu/eval/classifier.py`.

Capability parity with reference `src/classifier.py:11-303`: fit /
predict / test / binary_test / print_metrics / plot_roc_curve, macro
P/R/F1 + per-class classification report + confusion matrix. The
metrics are computed with numpy here, as sklearn computes them
(`precision_recall_fscore_support` with `zero_division=0`,
`confusion_matrix`, `classification_report(output_dict=True)`), so
nothing on the card needs sklearn. `fit` runs eagerly, one optimizer step
per batch.

The scripts' warm-start idiom `clf.model = gan.classifier` becomes
`clf.warm_start_from(trainer)`, which adopts a deep copy of the trainer's
companion classifier: a JAX array is immutable, so the JAX downstream fit
leaves the trainer's classifier (the qualified-sample filter) as it was,
and a copy keeps that true here.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import Adam, apply_eval, init_net, resolve_device
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.models import mlp
from cvaegan_tpu_torch.models.layers import forward_with
from cvaegan_tpu_torch.utils.logger import Logger


def _train_arrays(dataset):
    if isinstance(dataset, TabularDataset):
        return dataset.tr_samples, dataset.tr_labels
    x, y = dataset
    return np.asarray(x, np.float32), np.asarray(y, np.int32)


def _test_arrays(dataset):
    if isinstance(dataset, TabularDataset):
        return dataset.te_samples, dataset.te_labels
    x, y = dataset
    return np.asarray(x, np.float32), np.asarray(y, np.int32)


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
        #: host-clock seconds of the last `fit`
        self.fit_seconds: Optional[float] = None

    def _ensure_built(self, feature_num: int, label_num: int) -> None:
        if self.module is None:
            self.label_num = label_num
            self.module = init_net(mlp.Classifier(feature_num, label_num),
                                   torch.Generator().manual_seed(self.seed),
                                   self.device)

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

    # -------------------------------------------------------------- train
    def fit(self, dataset) -> None:
        """`settings.classifier.epochs` epochs of Adam (lr 1e-3, betas
        0.9/0.999) over batches of `batch_size` rows in a fresh permutation
        each epoch; the tail batch is filled with the permutation's first
        rows at weight 0 under the weighted cross entropy
        (`eval/classifier.py:136-186` of the JAX package)."""
        import time

        x, y = _train_arrays(dataset)
        self._ensure_built(x.shape[1], int(y.max()) + 1)
        self.logger.info("Started training")
        t0 = time.perf_counter()
        n, bs = len(x), self.cfg.batch_size
        nb = -(-n // bs)
        pad = nb * bs - n
        x_dev = torch.as_tensor(x, device=self.device)
        y_dev = torch.as_tensor(y, device=self.device).long()
        weights = torch.cat([torch.ones(n, device=self.device),
                             torch.zeros(pad, device=self.device)])
        module = self.module.train()
        opt = Adam(list(module.parameters()), self.cfg.lr)
        for _ in range(self.cfg.epochs):
            perm = torch.randperm(n, generator=self.generator, device=self.device)
            perm = torch.cat([perm, perm[:pad]])
            for b in range(nb):
                rows = perm[b * bs:(b + 1) * bs]
                self._step(opt, x_dev[rows], y_dev[rows], weights[b * bs:(b + 1) * bs])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fit_seconds = time.perf_counter() - t0
        self.logger.info("Finished training")

    def _step(self, opt: Adam, bx, by, bw) -> torch.Tensor:
        """One optimizer step on a batch with per-row weights."""
        out = forward_with(self.module, bx, generator=self.generator)
        logits = out[0] if isinstance(out, tuple) else out
        loss = losses.weighted_cross_entropy(logits, by, bw)
        opt.step(torch.autograd.grad(loss, opt.params))
        return loss.detach()

    # ------------------------------------------------------------ predict
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
