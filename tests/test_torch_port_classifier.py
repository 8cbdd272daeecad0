"""The port's downstream `Classifier` against the JAX package's.

One optimizer step on a padded tail batch (weight-0 rows) against the JAX
package's batch step (`Classifier.apply` in train mode, the weighted cross
entropy, `optax.adam(1e-3)`) from the same weights, on the same dropout
keep-masks, and from the same Adam state (count 3, moments drawn with
numpy, nu >= 1e-8; from zero moments a first step moves each parameter
by lr g / (|g| + 1e-8), which turns the float32 rounding of a gradient
near 1e-8 into parameter differences above the tolerance, as
`tests/test_torch_port_training.py` explains): parameters and Adam
moments at rtol 1e-5, atol 1e-6. The
metrics, computed with numpy in the port, must equal sklearn's on random
label vectors with absent classes. `fit` visits every row once per epoch
at weight 1, and `warm_start_from` adopts a copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn import metrics as skm

from cvaegan_tpu.core import losses as jlosses
from cvaegan_tpu.models import mlp as jm
from cvaegan_tpu_torch import CVAEGAN, Classifier
from cvaegan_tpu_torch.convert import load_adam, load_net, net_leaves
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.core.state import Adam
from cvaegan_tpu_torch.eval.classifier import classification_metrics
from cvaegan_tpu_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-6)
FEATURES, CLASSES, N, BS = 30, 5, 100, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def settings(tmp_path):
    s = tconfig.Settings()
    s.classifier.epochs = 2
    s.paths = tconfig.Paths(root=tmp_path)
    return s


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (rng.random((n, FEATURES), dtype=np.float32),
            (np.arange(n) % CLASSES).astype(np.int32))


def test_one_padded_step_matches_optax(monkeypatch, settings):
    x, y = _data()
    module = jm.Classifier(num_classes=CLASSES)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((2, FEATURES)), train=False)["params"]
    # the tail batch of an epoch: 36 real rows, then 28 rows of the
    # permutation's head at weight 0
    perm = np.random.default_rng(1).permutation(N)
    rows = np.concatenate([perm[BS:], perm[:2 * BS - N]])
    w = np.concatenate([np.ones(N - BS), np.zeros(2 * BS - N)]).astype(np.float32)
    bx, by = x[rows], y[rows]

    rng, queue = np.random.default_rng(2), []

    def bernoulli(key, p=0.5, shape=None):
        queue.append(rng.random(shape) < p)
        return jnp.asarray(queue[-1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(tl, "_keep_mask", lambda x, keep_prob, generator:
                        torch.from_numpy(queue.pop(0)))

    def loss_fn(p):
        logits = module.apply({"params": p}, bx, train=True,
                              rngs={"dropout": jax.random.PRNGKey(3)})
        return jlosses.weighted_cross_entropy(logits, by, w)

    tx = optax.adam(settings.classifier.lr)
    draws = np.random.default_rng(5)
    opt_state = tx.init(params)
    opt_state = (opt_state[0]._replace(
        count=jnp.int32(3),
        mu=jax.tree.map(lambda a: jnp.asarray(draws.normal(0, 1e-4, a.shape), jnp.float32),
                        opt_state[0].mu),
        nu=jax.tree.map(lambda a: jnp.asarray(draws.uniform(1e-8, 1e-6, a.shape), jnp.float32),
                        opt_state[0].nu)), *opt_state[1:])
    start = jax.device_get({"count": opt_state[0].count, "mu": opt_state[0].mu,
                            "nu": opt_state[0].nu})
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    new_params = optax.apply_updates(params, updates)

    clf = Classifier("t", seed=0, settings=settings, device="cpu")
    clf._ensure_built(FEATURES, CLASSES)
    load_net(clf.module, jax.device_get({"params": params}))
    opt = Adam(list(clf.module.parameters()), settings.classifier.lr)
    load_adam(opt, clf.module, start)
    got = clf._step(opt, torch.from_numpy(bx), torch.from_numpy(by).long(),
                    torch.from_numpy(w))
    assert not queue
    np.testing.assert_allclose(got.numpy(), np.asarray(loss), **TOL)
    tree = jax.device_get({"params": new_params})
    moments = jax.device_get({"mu": opt_state[0].mu, "nu": opt_state[0].nu})
    slot = {id(p): i for i, p in enumerate(opt.params)}
    for path, (tensor, transposed) in net_leaves(clf.module).items():
        for got_t, want in ((tensor, tree), (opt.m[slot[id(tensor)]], {"params": moments["mu"]}),
                            (opt.v[slot[id(tensor)]], {"params": moments["nu"]})):
            leaf = want
            for key in path:
                leaf = leaf[key]
            leaf = np.asarray(leaf)
            np.testing.assert_allclose(got_t.detach().numpy(), leaf.T if transposed else leaf,
                                       err_msg="/".join(path), **TOL)


def test_fit_visits_every_row_once_per_epoch(monkeypatch, settings):
    x, y = _data()
    x[:, 0] = np.arange(N)  # row ids ride in feature 0
    clf = Classifier("t", seed=0, settings=settings, device="cpu")
    seen = []
    step = clf._step

    def record(opt, bx, by, bw):
        seen.append((bx[:, 0].long().tolist(), bw.tolist()))
        return step(opt, bx, by, bw)

    monkeypatch.setattr(clf, "_step", record)
    clf.fit((x, y))
    nb = -(-N // settings.classifier.batch_size)
    assert len(seen) == settings.classifier.epochs * nb
    for e in range(settings.classifier.epochs):
        rows = [r for b in seen[e * nb:(e + 1) * nb] for r in b[0]]
        weights = [w for b in seen[e * nb:(e + 1) * nb] for w in b[1]]
        assert sorted(r for r, w in zip(rows, weights) if w == 1.0) == list(range(N))
        assert weights[N:] == [0.0] * (len(rows) - N)
        assert rows[N:] == rows[:len(rows) - N]
    assert clf.fit_seconds is not None


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_sklearn(seed):
    rng = np.random.default_rng(seed)
    real = rng.choice([0, 1, 3], 40)          # classes 2 and 4 absent from real
    pred = rng.integers(0, 4, 40)             # class 4 never predicted
    for labels in (list(range(CLASSES)), None):
        cm, macro, report = classification_metrics(real, pred, labels)
        np.testing.assert_array_equal(cm, skm.confusion_matrix(real, pred, labels=labels))
        for key, fn in (("Precision", skm.precision_score), ("Recall", skm.recall_score),
                        ("F1", skm.f1_score)):
            assert macro[key] == pytest.approx(
                fn(real, pred, average="macro", zero_division=0), abs=1e-12)
        want = skm.classification_report(real, pred, labels=labels, output_dict=True,
                                         zero_division=0)
        assert set(report) == set(want)
        for key, value in want.items():
            assert report[key] == pytest.approx(value, abs=1e-12), key


def test_test_and_binary_test(monkeypatch, settings):
    x, y = _data()
    clf = Classifier("t", seed=0, settings=settings, device="cpu")
    clf._ensure_built(FEATURES, CLASSES)
    pred = np.random.default_rng(4).integers(0, CLASSES, N)
    monkeypatch.setattr(clf, "predict", lambda _: pred)
    clf.test((x, y))
    assert clf.metrics["F1"] == pytest.approx(
        skm.f1_score(y, pred, average="macro", zero_division=0), abs=1e-12)
    assert clf.confusion_matrix.shape == (CLASSES, CLASSES)
    clf.binary_test((x, y))
    assert clf.metrics["Recall"] == pytest.approx(
        skm.recall_score(y > 0, pred > 0, average="macro", zero_division=0), abs=1e-12)
    clf.print_metrics()


def test_warm_start_adopts_a_copy(settings):
    x, y = _data()
    gan = CVAEGAN(seed=0, device="cpu", settings=settings)
    gan._prepare((x, y))
    clf = Classifier("t", seed=0, settings=settings, device="cpu")
    clf.warm_start_from(gan)
    assert clf.label_num == CLASSES
    before = [p.detach().clone() for p in gan.state["classifier"].parameters()]
    for a, b in zip(clf.module.parameters(), before):
        assert torch.equal(a, b) and a is not b
    clf.fit((x, y))
    for a, b in zip(gan.state["classifier"].parameters(), before):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(clf.module.parameters(), before))
    assert clf.predict(x).shape == (N,)
    np.testing.assert_allclose(clf.get_feature_importance(),
                               np.abs(clf.module.layers[0].weight.detach().numpy()).mean(0),
                               rtol=1e-6)
