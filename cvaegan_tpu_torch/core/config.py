"""Typed configuration for the PyTorch port.

A copy of `cvaegan_tpu/core/config.py` with identical defaults (the port
imports nothing of the JAX package). `GanConfig.compute_dtype` stays a
field so that settings objects carry across, but the port runs float32
only: `check_compute_dtype` rejects anything else.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict


@dataclasses.dataclass
class GanConfig:
    """Shared GAN-family training hyperparameters (reference
    `src/config/gan_config.py:1-13`)."""

    epochs: int = 500
    batch_size: int = 128
    z_size: int = 128
    g_lr: float = 2e-4
    g_loop_num: int = 3
    d_lr: float = 2e-4
    d_loop_num: int = 5
    c_lr: float = 1e-4
    c_loop_num: int = 5
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    # "float32" only in the port; the bfloat16 policy is ROADMAP item A20.
    compute_dtype: str = "float32"


@dataclasses.dataclass
class ClassifierConfig:
    """Downstream evaluation classifier (reference
    `src/config/classifier_config.py:1-3`)."""

    epochs: int = 100
    lr: float = 1e-3
    batch_size: int = 64


# Per-model loss-weight dictionaries (reference `src/config/gan_config.py:15-93`).
MODEL_CONFIGS: Dict[str, Dict[str, float]] = {
    "cvae_gan": {
        "lambda_recon": 1.0,
        "lambda_kl": 0.1,
        "lambda_adv": 1.0,
        "lambda_class": 0.5,
        "confidence_threshold": 0.5,
    },
    "vae_gan": {
        "lambda_recon": 1.0,
        "lambda_kl": 0.01,
        "lambda_adv": 0.1,
        "confidence_threshold": 0.5,
    },
    "cgan": {
        "lambda_adv": 1.0,
        "lambda_class": 0.5,
        "confidence_threshold": 0.5,
    },
    "gan": {
        "lambda_adv": 1.0,
        "confidence_threshold": 0.5,
    },
    "cvae": {
        "lambda_recon": 1.0,
        "lambda_kl": 0.01,
        "lambda_class": 0.1,
        "confidence_threshold": 0.5,
    },
    "vae": {
        "lambda_recon": 1.0,
        "lambda_kl": 0.01,
        "confidence_threshold": 0.5,
    },
    "sngan": {
        "lambda_adv": 1.0,
        "lambda_class": 0.5,
        "confidence_threshold": 0.5,
    },
    "qg_smote": {
        "num_quantiles": 3,
        "lambda_recon": 1.0,
        "lambda_quantile": 0.5,
        "lambda_adv": 0.1,
        "lambda_class": 0.1,
        "confidence_threshold": 0.5,
    },
    "ctgan": {
        "lambda_adv": 1.0,
        "lambda_class": 0.5,
        "lambda_gp": 10.0,
        "confidence_threshold": 0.5,
    },
    "rain_gan": {
        "lambda_recon": 1.0,
        "lambda_kl": 0.01,
        "lambda_adv": 0.1,
        "lambda_class": 0.1,
        "lambda_attention": 0.01,
        "confidence_threshold": 0.5,
    },
    "tmg_gan": {
        "confidence_threshold": 0.5,
    },
}


@dataclasses.dataclass
class Paths:
    """Output directory layout (reference `src/config/path_config.py:3-12`),
    created lazily on first use."""

    root: pathlib.Path = dataclasses.field(
        default_factory=lambda: pathlib.Path(__file__).resolve().parents[2] / "data"
    )

    @property
    def logs(self) -> pathlib.Path:
        return self._ensure(self.root / "logs")

    @property
    def datasets(self) -> pathlib.Path:
        return self._ensure(self.root / "datasets")

    @property
    def gan_outs(self) -> pathlib.Path:
        return self._ensure(self.root / "gan_outs")

    @staticmethod
    def _ensure(p: pathlib.Path) -> pathlib.Path:
        p.mkdir(parents=True, exist_ok=True)
        return p


@dataclasses.dataclass
class Settings:
    """Global knobs (reference `src/config/__init__.py:14-23`). The device
    is not a setting: every trainer takes `device=` explicitly."""

    seed: int = 0
    gan: GanConfig = dataclasses.field(default_factory=GanConfig)
    classifier: ClassifierConfig = dataclasses.field(default_factory=ClassifierConfig)
    paths: Paths = dataclasses.field(default_factory=Paths)


# Mutable process-wide default, as in the reference's config module.
settings = Settings()


def turn_on_test_mode() -> None:
    """Drop epoch counts to 1 for fast smoke runs (reference
    `src/utils.py:86-92`)."""
    settings.gan.epochs = 1
    settings.classifier.epochs = 1


def check_compute_dtype(gan_cfg: GanConfig) -> None:
    """Raise unless the compute policy is float32, the only one ported."""
    if gan_cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={gan_cfg.compute_dtype!r}: the PyTorch port runs "
            "float32 only; the bfloat16 policy is ROADMAP item A20")
