"""Checkpoint and resume of a trainer, the counterpart of
`cvaegan_tpu/utils/checkpoint.py`.

A checkpoint is a directory of two files:
  * `state.pt`: `torch.save` of every network's `state_dict` (parameters
    and buffers: BatchNorm statistics, spectral u/v), every optimizer's
    tensors (moments and the device step count; TMG-GAN's one Adam per
    generator) and the trainer's generator state;
  * `meta.json`: the JAX package's keys (`name`, `feature_num`,
    `label_num`, `loss_history`) and the device type the state came from.
The format is not the JAX package's Orbax format: neither package reads
the other's checkpoints.

A save writes a temporary directory beside `path` and moves it into
place with `os.replace`, so a reader finds the old checkpoint or the new
one, never half of one. A restore copies every tensor into the trainer's
own, in place, so a captured epoch that reads them stays valid. A
generator's state is restored only on the device type it was saved on (a
CUDA generator's state is a Philox seed and offset, a CPU one's a
Mersenne Twister's); elsewhere the restore says so in one line and the
trainer keeps its seed's stream.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile

import torch


def save_checkpoint(trainer, path) -> pathlib.Path:
    """Save a trainer's state and metadata into the directory `path`."""
    if trainer.state is None:
        raise RuntimeError(f"{trainer.name}: nothing to checkpoint; call fit() first")
    path = pathlib.Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".{path.name}.", dir=path.parent))
    try:
        torch.save({"state": trainer.state.state_dict(),
                    "optimizers": {name: opt.tensors()
                                   for name, opt in trainer.optimizers.items()},
                    "generator": trainer.generator.get_state()}, tmp / "state.pt")
        meta = {"name": trainer.name, "feature_num": trainer.feature_num,
                "label_num": trainer.label_num,
                "loss_history": {k: list(map(float, v))
                                 for k, v in trainer.loss_history.items()},
                "device_type": trainer.device.type}
        (tmp / "meta.json").write_text(json.dumps(meta))
        if path.exists():  # a directory cannot replace a non-empty one
            old = pathlib.Path(tempfile.mkdtemp(prefix=f".{path.name}.old.",
                                                dir=path.parent))
            os.replace(path, old / "checkpoint")
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)
    return path


def restore_checkpoint(trainer, path, dataset) -> None:
    """Restore a trainer saved by `save_checkpoint`. `dataset` is the
    training data (or data of the same shapes): it builds the networks and
    the device data before the saved tensors are copied into them."""
    path = pathlib.Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text())
    trainer._prepare(dataset)
    if (trainer.feature_num, trainer.label_num) != (meta["feature_num"], meta["label_num"]):
        raise ValueError(
            f"checkpoint shape mismatch: saved (features={meta['feature_num']}, "
            f"labels={meta['label_num']}) vs dataset (features={trainer.feature_num}, "
            f"labels={trainer.label_num})")
    saved = torch.load(path / "state.pt", map_location=trainer.device, weights_only=True)
    trainer.state.load_state_dict(saved["state"])
    with torch.no_grad():
        for name, opt in trainer.optimizers.items():
            for dst, src in zip(opt.tensors(), saved["optimizers"][name], strict=True):
                dst.copy_(src)
    if meta["device_type"] == trainer.device.type:
        trainer.generator.set_state(saved["generator"].cpu())  # a host ByteTensor
    else:
        print(f"{trainer.name}: the checkpoint's generator state is from a "
              f"{meta['device_type']} generator; this {trainer.device.type} trainer "
              "keeps its seed's stream")
    trainer.loss_history = {k: list(v) for k, v in meta["loss_history"].items()}
    trainer._clear_gen_caches()
