"""The QG-SMOTE model family, the counterparts of
`cvaegan_tpu/models/quantile.py` (reference `src/models/qg_smote_models.py`).

The quantile encoder maps each (x, y) to `latent_dim x num_quantiles`
latent quantile values; latent sampling interpolates between adjacent
quantiles at a random alpha, the SMOTE analogy (`:68-83`). A separate
quantile regressor predicts feature-space quantiles, trained with the
pinball loss (`src/qg_smote.py:272-294`). The generator, critic and
classifier are the shared MLP family's (`models/mlp.py`).

As in `models/mlp.py`, each constructor takes its input width first and
modules one-hot their integer labels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cvaegan_tpu_torch.models.layers import Dense, Dropout, MLPTrunk, hidden_sizes, one_hot


class QuantileEncoder(nn.Module):
    """concat(x, onehot(y)) -> MLP trunk -> Dense(latent_dim * num_quantiles),
    reshaped to `[batch, latent_dim, num_quantiles]`
    (`src/models/qg_smote_models.py:8-66`)."""

    def __init__(self, input_dim: int, num_classes: int, latent_dim: int = 128,
                 num_quantiles: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.latent_dim, self.num_quantiles = latent_dim, num_quantiles
        d = input_dim + num_classes
        hs = hidden_sizes(d)
        self.trunk = MLPTrunk(d, hs)
        self.head = Dense(hs[-1], latent_dim * num_quantiles)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        h = self.trunk(torch.cat([x, one_hot(labels, self.num_classes)], dim=-1))
        q = self.head(h)
        return q.reshape(*q.shape[:-1], self.latent_dim, self.num_quantiles)


def sample_from_quantiles(quantiles: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Interpolation between adjacent latent quantiles at `alpha` `[batch,
    1]` in [0, 1] (`src/models/qg_smote_models.py:68-83`): the index
    alpha (nq - 1), its floor and ceiling, weights by its fraction.

    quantiles: `[batch, latent_dim, num_quantiles]` -> z `[batch, latent_dim]`.
    """
    nq = quantiles.shape[-1]
    idx_float = alpha * (nq - 1)
    idx_lower = torch.floor(idx_float)
    idx_upper = torch.ceil(idx_float)
    w_upper = idx_float - idx_lower
    w_lower = 1.0 - w_upper

    def take(idx):
        index = idx.long().unsqueeze(-1).expand(*quantiles.shape[:-1], 1)
        return torch.gather(quantiles, -1, index)[..., 0]

    return w_lower * take(idx_lower) + w_upper * take(idx_upper)


class QuantileRegressor(nn.Module):
    """Feature-space quantile head (`src/models/qg_smote_models.py:235-283`):
    concat(x, onehot(y)) -> Dense + ReLU + Dropout(0.3) -> Dense + ReLU ->
    Dense, reshaped to `[batch, in_features, num_quantiles]`."""

    def __init__(self, in_features: int, num_classes: int, num_quantiles: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.in_features, self.num_quantiles = in_features, num_quantiles
        d = in_features + num_classes
        h1, h2, _ = hidden_sizes(d)
        self.layers = nn.ModuleList([Dense(d, h1), Dense(h1, h2),
                                     Dense(h2, in_features * num_quantiles)])
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l1, l2, l3 = self.layers
        h = torch.cat([x, one_hot(labels, self.num_classes)], dim=-1)
        h = self.dropout(torch.relu(l1(h)), generator)
        out = l3(torch.relu(l2(h)))
        return out.reshape(*out.shape[:-1], self.in_features, self.num_quantiles)
