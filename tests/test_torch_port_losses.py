"""The port's losses and loss-weight schedule against the JAX package's.

The same numpy inputs go through `cvaegan_tpu.core.{losses,schedules}` and
`cvaegan_tpu_torch.core.{losses,schedules}`; every result must agree
within 1e-6 (relative and absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvaegan_tpu.core import losses as jl
from cvaegan_tpu.core import schedules as js
from cvaegan_tpu_torch.core import losses as tl
from cvaegan_tpu_torch.core import schedules as ts

TOL = dict(rtol=1e-6, atol=1e-6)
N, D, C = 37, 9, 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _arr(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _labels(seed, n=N, c=C):
    return np.random.default_rng(seed).integers(0, c, n).astype(np.int32)


def _same(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **TOL)


@pytest.mark.parametrize("epoch", [0, 199, 200, 350, 499, 500, 600])
def test_progressive_lambda(epoch):
    want = js.progressive_lambda(epoch, 0.5, 200, 500)
    _same(ts.progressive_lambda(epoch, 0.5, 200, 500), want)
    _same(ts.progressive_lambda(torch.tensor(float(epoch)), 0.5, 200, 500), want)


def _pairs():
    """(name, port result, JAX result) for every loss but the penalty."""
    a, b = _arr(0, N, D), _arr(1, N, D)
    mu, lv = _arr(2, N, D), _arr(3, N, D, scale=0.5)
    logits, y = _arr(4, N, C, scale=3.0), _labels(5)
    w = np.random.default_rng(6).random(N).astype(np.float32)
    w[::3] = 0.0
    s1, s2 = _arr(7, N, 1), _arr(8, N, 1)
    pred, target = _arr(9, N, 3, D), _arr(10, N, D)
    q = np.array([0.25, 0.5, 0.75], np.float32)
    real, fake = np.random.default_rng(11).random((150, D), dtype=np.float32), \
        np.random.default_rng(12).random((120, D), dtype=np.float32)
    t = torch.from_numpy
    return [
        ("mse", tl.mse(t(a), t(b)), jl.mse(a, b)),
        ("kl", tl.kl_standard_normal(t(mu), t(lv)), jl.kl_standard_normal(mu, lv)),
        ("ce", tl.cross_entropy(t(logits), t(y)), jl.cross_entropy(logits, y)),
        ("wce", tl.weighted_cross_entropy(t(logits), t(y), t(w)),
         jl.weighted_cross_entropy(logits, y, w)),
        ("wce_zero_weights", tl.weighted_cross_entropy(t(logits), t(y), t(0 * w)),
         jl.weighted_cross_entropy(logits, y, 0 * w)),
        ("wasserstein_d", tl.wasserstein_d_loss(t(s1), t(s2)), jl.wasserstein_d_loss(s1, s2)),
        ("wasserstein_g", tl.wasserstein_g_loss(t(s2)), jl.wasserstein_g_loss(s2)),
        ("hinge_d", tl.hinge_d_loss(t(s1), t(s2)), jl.hinge_d_loss(s1, s2)),
        ("pinball", tl.pinball(t(pred), t(target), t(q)), jl.pinball(pred, target, q)),
        ("cosine", tl.cosine_similarity(t(a), t(b)), jl.cosine_similarity(a, b)),
        ("mean_difference", tl.mean_difference(t(real), t(fake)),
         jl.mean_difference(real, fake)),
        ("cov_difference", tl.cov_difference(t(real), t(fake)),
         jl.cov_difference(real, fake)),
        ("mmd_rbf", tl.mmd_rbf(t(real), t(fake)), jl.mmd_rbf(real, fake)),
    ]


@pytest.mark.parametrize("name", [p[0] for p in _pairs()])
def test_loss_matches_jax(name):
    (got, want), = [(g, w) for n, g, w in _pairs() if n == name]
    _same(got, want)


def test_gradient_penalty_matches_jax():
    """A row-wise critic tanh(x W + b) v in both frameworks; the port takes
    the interpolation weights JAX draws from its key."""
    w1, b1, v = _arr(20, D, 16, scale=0.5), _arr(21, 16), _arr(22, 16, 1)
    x_real, x_fake = _arr(23, N, D), _arr(24, N, D)
    key = jax.random.PRNGKey(3)
    alpha = np.array(jax.random.uniform(key, (N, 1)))

    def j_critic(x):
        return jnp.tanh(x @ w1 + b1) @ v

    def t_critic(x):
        return torch.tanh(x @ torch.from_numpy(w1) + torch.from_numpy(b1)) @ torch.from_numpy(v)

    want = jl.gradient_penalty(j_critic, x_real, x_fake, key)
    got = tl.gradient_penalty(t_critic, torch.from_numpy(x_real),
                              torch.from_numpy(x_fake), alpha=torch.from_numpy(alpha))
    _same(got, want)


def test_attention_entropy_still_matches():
    p = np.random.default_rng(30).dirichlet(np.ones(7), size=(4, 6)).astype(np.float32)
    _same(tl.attention_entropy(torch.from_numpy(p)), jl.attention_entropy(p))
