"""The bf16 policy on the other ten trainers' steps, against the JAX package's.

`tests/test_torch_port_bf16.py` holds the CVAE-GAN's D, C and E+G steps
under `compute_dtype="bfloat16"` to JAX's. Here the same gate holds one
step of every kind each other trainer's epoch runs (CVAE, VAE-GAN, GAN,
CGAN, SNGAN, CTGAN, TMG-GAN, QG-SMOTE, RAIN-GAN and VAE: D, C, E+G or G,
QG-SMOTE's quantile regressor, TMG-GAN's CD and diversity steps), and
each trainer's eval forwards under the policy: the companion classifier's
logits (CD's probabilities for TMG-GAN), which decide qualified yield,
and the generator's (or decoder's) samples.

Each step runs three ways from the warm state its float32 test starts from
(BatchNorm statistics and Adam moments drawn, spectral u/v drawn and
power-iterated: `test_torch_port_sngan_ctgan.jax_twin`, and TMG-GAN's and
QG-SMOTE's own twins), on the same inputs (drawn on the JAX side from the
step's own key split, through the float32 tests' `_steps`) and the same
dropout keep-masks (`_replayed_masks`): the JAX step under the policy,
its new state carried into a port trainer with `load_jax_state`; the
port's step under the policy; and the port's step in float64 with no
policy, the exact step. JAX's reparameterisation draws its noise in the
activations' dtype, so under the policy eps is drawn in bf16 (`_steps`
here, for CVAE, VAE, VAE-GAN and RAIN-GAN).

The gate is the CVAE-GAN's (`test_torch_port_bf16.py`): losses agree with
JAX's within BF16_TOL; every parameter, buffer and Adam tensor stays
float32 (or int32); and each tensor is as exact as JAX's (`as_exact_as`:
its largest error from the float64 step is within BF16_TOL of the
tensor's scale, or no more than twice JAX's). Eval outputs have JAX's
dtype and are as exact as JAX's against the float64 forward on the same
bf16-rounded input. Six steps miss that gate at their own key by where
bf16 rounding lands, in either package (`ANCHORED`): they are held over
six keys, each loss and tensor at each key to the same rule, and the
port may miss it no more often than JAX misses the mirrored rule at the
same keys (`assert_anchored`; RAIN-GAN's D step by its worst key,
`WORST_KEY`; ROADMAP C9).

CTGAN's, TMG-GAN's and QG-SMOTE's steps run in
`test_torch_port_bf16_zoo_steps.py`, RAIN-GAN's steps and eval forwards in
`test_torch_port_bf16_zoo_rain.py`, on this module's helpers.
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_port_family as family
import test_torch_port_qg_smote as qg
import test_torch_port_sngan_ctgan as snct
import test_torch_port_tmg_gan as tmg
import torch
from test_torch_port_bf16 import BF16_TOL, _bf16_rounded, _dtype, as_exact_as
from test_torch_port_bf16 import bf16  # noqa: F401  (a fixture)
from test_torch_port_family import _tree
from test_torch_port_sngan_ctgan import _replayed_masks

from cvaegan_tpu_torch.core import losses as tlosses
from cvaegan_tpu_torch.models import layers as tl

EPOCH = 350.0  # inside the lambda_class ramp
CLASS_ID = 2
#: the kinds of step each trainer's epoch runs
KINDS = {"CVAE": "cg", "VAEGAN": "dg", "GAN": "dcg", "CGAN": "dcg", "SNGAN": "dcg",
         "CTGAN": "dcg", "TMGGAN": ("cd", "g", "div"), "QG_SMOTE": "dcqg",
         "RAIN_GAN": "dcg", "VAE": "cg"}
#: trainers whose E+G step reparameterises (eps in the activations' dtype)
REPARAMETERISED = ("CVAE", "VAE", "VAEGAN", "RAIN_GAN")
#: the float32 test modules whose `_steps` draw a trainer's inputs
STEP_MODULES = (family, snct, qg, tmg)
CASES = [(name, kind) for name, kinds in KINDS.items() for kind in kinds]
#: the trainers whose steps run in this module; CTGAN's, TMG-GAN's and
#: QG-SMOTE's run in `test_torch_port_bf16_zoo_steps.py`, RAIN-GAN's in
#: `test_torch_port_bf16_zoo_rain.py`
LIGHT = ("CVAE", "VAEGAN", "GAN", "CGAN", "SNGAN", "VAE")
#: steps that miss the gate at their own key, on one tensor or the loss,
#: and are held to float64 over ANCHOR_KEYS keys (`assert_anchored`,
#: ROADMAP C9). A tensor's largest error under bf16 swings with where the
#: rounding lands: at the same keys JAX's steps miss the mirrored gate (JAX
#: held to twice the port's error) as often or more (over the six keys,
#: the port's misses against JAX's: GAN C 2/2, VAE-GAN D 1/2, CTGAN D 7/48,
#: CTGAN G 2/60, TMG-GAN diversity 22/25;
#: `experiments/torch_port_bf16_gate_study.py counts`).
ANCHORED = {("GAN", "c"), ("VAEGAN", "d"), ("CTGAN", "d"), ("CTGAN", "g"),
            ("TMGGAN", "div"), ("RAIN_GAN", "d")}
ANCHOR_KEYS = 6
#: ANCHORED steps held by their worst key instead of by the count of
#: misses: each loss's and tensor's largest error over the keys within
#: BF16_TOL of its scale or twice JAX's largest. RAIN-GAN's D step misses
#: the count (2 against JAX's 0 over the six keys; 18 against 3 over 24),
#: all on eight tensors at the top of the critic, whose largest error is
#: ~1.5x JAX's at most keys while six others are ~1.4x better; its critic
#: flips as many signs of the last block's output as JAX's, and on block
#: 1's `ff2.bias` gradient its largest error is 1.5x JAX's while its mean
#: error is lower (ROADMAP C9).
WORST_KEY = {("RAIN_GAN", "d")}
#: D steps whose fake rows are the float64 generator's, rounded to bf16 for
#: both packages' policy steps: RAIN-GAN's generator ends in a bf16
#: sigmoid, which the port rounds correctly (largest error half an ulp)
#: and XLA does not (`test_torch_port_bf16_zoo_rain.py`); JAX's rows
#: happen to offset its critic's own rounding, so on each package's own
#: rows the port's loss lies ~3e-4 from float64, JAX's ~1e-4, and on the
#: same rows both ~3e-4
SAME_ROWS = {("RAIN_GAN", "d")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _twins(name, blob_dataset):
    """(JAX trainer, its warm state, a function making a port trainer
    loaded from that state), as the trainer's float32 step test builds
    them."""
    if name == "TMGGAN":
        jt, state, _ = tmg.jax_twin(blob_dataset)
        return jt, state, lambda: tmg.port_twin(blob_dataset)
    if name == "QG_SMOTE":
        jt, state, _ = qg.jax_twin(blob_dataset)
        return jt, state, lambda: qg.port_twin(blob_dataset)
    jt, state, _ = snct.jax_twin(name, blob_dataset)
    return jt, state, lambda: snct.port_twin(name, blob_dataset)


#: the float dtype `_t` gives; float64 for the exact step
FLOAT = np.float32


def _t(*arrays):
    """Tensors of jax or numpy arrays, floats (bf16 included) as `FLOAT`."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(FLOAT)
        out.append(torch.from_numpy(np.array(a)))
    return out


def _eps(jt, key):
    return jax.random.normal(key, (jt.gan_cfg.batch_size, jt.gan_cfg.z_size), jnp.bfloat16)


def _steps(name, kind, jt, port, key):
    """(the JAX step as a function of (state, key), the port's step on the
    same inputs as a thunk): the float32 tests' `_steps`, but for the
    reparameterised E+G steps, whose eps is drawn here in bf16."""
    data = jt._data
    if kind == "g" and name in REPARAMETERISED:
        if name == "VAE":
            k_x, k_eps = jax.random.split(key)
            x, _ = family._random_batch(jt, k_x)
            x, eps = _t(x, _eps(jt, k_eps))
            return (lambda s, k: jt._g_step(s, data, k), lambda: port._g_step(x, eps))
        if name == "VAEGAN":
            k_x, k_eps, k_z, _ = jax.random.split(key, 4)
            x, _ = family._random_batch(jt, k_x)
            x, eps, z = _t(x, _eps(jt, k_eps), family._normal(jt, k_z))
            return (lambda s, k: jt._g_step(s, data, k), lambda: port._g_step(x, z, eps))
        lam = port._lambda_class(torch.tensor(EPOCH))
        jax_g = lambda s, k: jt._g_step(s, data, CLASS_ID, jnp.float32(EPOCH), k)  # noqa: E731
        if name == "CVAE":
            k_x, k_eps, _ = jax.random.split(key, 3)
            x, y, eps = _t(*jt._sample_batch(k_x, data, CLASS_ID), _eps(jt, k_eps))
            return jax_g, lambda: port._g_step(x, y.long(), eps, lam)
        k_x, k_eps, k_z = jax.random.split(key, 3)  # RAIN-GAN
        x, y, eps, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), _eps(jt, k_eps),
                          family._normal(jt, k_z))
        return jax_g, lambda: port._g_step(x, y.long(), z, eps, lam)
    if name == "TMGGAN":
        return tmg._steps(kind, jt, port, key, EPOCH if kind == "g" else None)
    if name == "QG_SMOTE":
        return qg._steps(kind, jt, port, key)
    if name in family.NAMES:
        return family._steps(name, kind, jt, port, key)
    if name == "RAIN_GAN":
        k_x, k_z = jax.random.split(key)
        x, y, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), family._normal(jt, k_z))
        step = jt._d_step if kind == "d" else jt._c_step
        return (lambda s, k: step(s, data, CLASS_ID, k),
                lambda: (port._d_step if kind == "d" else port._c_step)(x, y.long(), z))
    return snct._steps(name, kind, jt, port, key)


def _float64(trainer):
    """The trainer's networks and Adam moments in float64, in place."""
    trainer.state.double()
    for opt in trainer.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    return trainer


def _step_runs(name, kind, blob_dataset, monkeypatch, keys, fault=contextlib.nullcontext):
    """One step three ways (see the module docstring) from each of `keys`,
    the JAX step compiled once (its dropout masks are constants of the
    compiled step, drawn when it is traced, and replayed to every port
    run); the port's policy step runs inside `fault()`. Returns, per key, a
    dict: the three trainers after the step (`port`, `from_jax`, `exact`)
    and the losses (`got`, `want`, `got64`)."""
    replay = _replayed_masks(monkeypatch)
    jt, state, make_port = _twins(name, blob_dataset)
    same_rows = (name, kind) in SAME_ROWS
    jitted, runs = None, []
    for k in keys:
        key = jax.random.PRNGKey(k)
        run = {"port": make_port(), "from_jax": make_port(), "exact": _float64(make_port())}
        if same_rows:
            _feed_float64_rows(jt, run, make_port, key, monkeypatch)
            jitted = None  # the rows are constants of the traced step
        jax_step, port_step = _steps(name, kind, jt, run["port"], key)
        jitted = jitted or jax.jit(jax_step)
        new_state, run["want"] = jitted(state, key)
        replay()
        with fault():
            run["got"] = port_step()
        run["from_jax"].load_jax_state(_tree(new_state))
        with monkeypatch.context() as mp:
            mp.setattr(tlosses, "_f32", lambda *xs: xs[0] if len(xs) == 1 else xs)
            mp.setattr(sys.modules[__name__], "FLOAT", np.float64)
            for module in STEP_MODULES:
                mp.setattr(module, "_t", _t)
            _, exact_step = _steps(name, kind, jt, run["exact"], key)
            replay()
            with tl.dtype_override(torch.float32):
                run["got64"] = exact_step()
        runs.append(run)
    return runs


def _feed_float64_rows(jt, run, make_port, key, monkeypatch):
    """Give a RAIN-GAN D step's three runs the float64 generator's fake rows
    for the step's z and labels (drawn as `_steps` draws them): as they are
    to the float64 step, rounded to bf16 (the generator's output dtype
    under the policy) to the port's and JAX's."""
    k_x, k_z = jax.random.split(key)
    _, y = jt._sample_batch(k_x, jt._data, CLASS_ID)
    z = family._normal(jt, k_z)
    gen = _float64(make_port()).state["generator"].train()
    with torch.no_grad(), tl.dtype_override(torch.float32):
        rows = gen(torch.from_numpy(np.array(z, np.float64)),
                   torch.from_numpy(np.array(y)).long())[0]
    rows_bf16 = rows.to(torch.bfloat16)
    monkeypatch.setattr(jt, "_gen_fake", lambda s, z_, y_: (
        s, jnp.asarray(rows_bf16.float().numpy(), jnp.bfloat16)))
    monkeypatch.setattr(run["port"], "_fake", lambda z_, y_: rows_bf16)
    monkeypatch.setattr(run["exact"], "_fake", lambda z_, y_: rows)


def _losses(out):
    return {k: float(v) for k, v in out.items()} if isinstance(out, dict) else {
        "loss": float(out)}


def _tol(scale):
    return BF16_TOL["atol"] + BF16_TOL["rtol"] * scale


def gate_misses(err, theirs, scale):
    """(the port misses the gate, JAX misses the mirrored gate) on one loss
    or tensor: its largest |error| from the float64 step beyond BF16_TOL
    of `scale` and beyond twice the other package's."""
    tol = _tol(scale)
    return err > max(tol, 2.0 * theirs), theirs > max(tol, 2.0 * err)


def assert_anchored(per_key, worst_key=False):
    """The gate of an ANCHORED case. `per_key` holds, for each of
    ANCHOR_KEYS keys, {loss or tensor: (the port's largest |error| from the
    float64 step, JAX's, the float64 value's largest |value|)}. At each key
    each one is held to the per-key rule (`gate_misses`), and over the keys
    the port misses it no more often than JAX misses the mirrored rule.
    With `worst_key` (`WORST_KEY`), each one's largest error over the keys
    is held to the rule against JAX's largest."""
    assert len(per_key) == ANCHOR_KEYS
    assert len({tuple(items) for items in per_key}) == 1
    if worst_key:
        for item in per_key[0]:
            err, theirs, scale = (max(items[item][i] for items in per_key) for i in range(3))
            assert not gate_misses(err, theirs, scale)[0], (item, err, theirs, scale)
        return
    ours = [(k, item, errs) for k, items in enumerate(per_key)
            for item, errs in items.items() if gate_misses(*errs)[0]]
    theirs = sum(gate_misses(*errs)[1] for items in per_key for errs in items.values())
    assert len(ours) <= theirs, (ours, theirs)


def step_errors(run):
    """{loss or tensor: (the port's largest |error| from the float64 step,
    JAX's, the float64 value's largest |value|)} of one run; every tensor
    float32 (or int32) in both packages."""
    got, want, exact = (_losses(run[k]) for k in ("got", "want", "got64"))
    assert set(got) == set(want) == set(exact)
    errors = {f"loss {k}": (abs(got[k] - exact[k]), abs(want[k] - exact[k]), abs(exact[k]))
              for k in want}
    tensors = zip(*(run[k]._static_tensors() for k in ("port", "from_jax", "exact")))
    for i, (a, o, e) in enumerate(tensors):
        assert a.dtype in (torch.float32, torch.int32) and o.dtype == a.dtype, a.dtype
        a, o, e = (t.detach().double() for t in (a, o, e))
        errors[i] = (float((a - e).abs().max()), float((o - e).abs().max()),
                     float(e.abs().max()))
    return errors


def assert_gate(name, kind, runs):
    """The bf16 step gate (module docstring) on one run: losses within
    BF16_TOL of JAX's and each tensor `as_exact_as` JAX's; or, for an
    ANCHORED case, `assert_anchored` over runs from ANCHOR_KEYS keys."""
    if (name, kind) in ANCHORED:
        assert_anchored([step_errors(r) for r in runs], (name, kind) in WORST_KEY)
        return
    (run,) = runs
    got, want = _losses(run["got"]), _losses(run["want"])
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= _tol(abs(want[k])), (k, got[k], want[k])
    for i, (err, theirs, scale) in step_errors(run).items():
        if not isinstance(i, str):
            assert not gate_misses(err, theirs, scale)[0], (i, err, theirs, scale)


def case_keys(name, kind):
    """The case's key, and for an ANCHORED case ANCHOR_KEYS - 1 more."""
    first = 70 + CASES.index((name, kind))
    n = ANCHOR_KEYS if (name, kind) in ANCHORED else 1
    return [first + 100 * i for i in range(n)]


def check_step(name, kind, blob_dataset, monkeypatch):
    """One step under the policy (`assert_gate`): losses within BF16_TOL of
    JAX's (each a float32 reduction of bf16 activations), every parameter,
    buffer and Adam tensor float32 (or int32), and each tensor as exact as
    JAX's, per tensor (not element by element: gradients that are 0 in
    exact arithmetic carry bf16 rounding noise of another pattern in each
    framework, which Adam from the drawn moments normalises). The
    ANCHORED cases are held to float64 over ANCHOR_KEYS keys."""
    assert_gate(name, kind, _step_runs(name, kind, blob_dataset, monkeypatch,
                                       case_keys(name, kind)))


@pytest.mark.parametrize("name,kind", [c for c in CASES if c[0] in LIGHT])
def test_step_as_exact_as_jax(name, kind, blob_dataset, bf16, monkeypatch):  # noqa: F811
    """`check_step` for the six trainers of this module."""
    check_step(name, kind, blob_dataset, monkeypatch)


#: faults planted in the port's policy step, each of which the ANCHORED
#: gate must fail: the critic's leaky ReLU slope 0.19 for 0.2, and the
#: critic loss's fake half scaled by 0.99
PLANTED = {
    "leaky_slope": lambda mp: mp.setattr(tl, "LEAKY_SLOPE", 0.19),
    "fake_half": lambda mp: mp.setattr(tlosses, "wasserstein_d_loss", lambda r, f: (
        -torch.mean(r.float(), dim=(-2, -1)) + 0.99 * torch.mean(f.float(), dim=(-2, -1))))}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_anchored_gate_fails_a_planted_fault(fault, blob_dataset, bf16, monkeypatch):  # noqa: F811
    """VAE-GAN's D step (ANCHORED) over its keys with a fault planted in
    the port's policy step only: the port then misses the per-key rule far
    more often than JAX misses the mirrored one, and the gate fails."""
    @contextlib.contextmanager
    def planted():
        with monkeypatch.context() as mp:
            PLANTED[fault](mp)
            yield

    runs = _step_runs("VAEGAN", "d", blob_dataset, monkeypatch, case_keys("VAEGAN", "d"),
                      fault=planted)
    with pytest.raises(AssertionError):
        assert_gate("VAEGAN", "d", runs)


def _eval_inputs(blob_dataset, rows=200):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((rows, 128)).astype(np.float32)
    y = (np.arange(rows) % 5).astype(np.int32)
    return z, y, blob_dataset.te_samples[:rows]


def check_eval_forwards(name, blob_dataset):
    """The companion's eval logits (CD's probabilities for TMG-GAN; VAE-GAN
    has none) and the eval generator forward under the policy: JAX's dtype,
    and as exact as JAX's against the port's float64 forward of the same
    bf16-rounded inputs."""
    jt, state, make_port = _twins(name, blob_dataset)
    port = make_port()
    exact = _float64(make_port())
    z, y, x = _eval_inputs(blob_dataset)
    outputs = {
        "generator": (jt._generator_forward(state, jnp.asarray(z), jnp.asarray(y), None),
                      lambda m, a, b: m._generator_forward(m.state, a, b), (z, y)),
        "classifier": (jt._classifier_logits(state, jnp.asarray(x)),
                       lambda m, a: m._classifier_logits(m.state, a), (x,))}
    checked = 0
    for what, (want, forward, args) in outputs.items():
        got = forward(port, *map(torch.from_numpy, args))
        if want is None:
            assert got is None and name == "VAEGAN" and what == "classifier"
            continue
        with torch.no_grad(), tl.dtype_override(torch.float32):
            ref = forward(exact, *[torch.from_numpy(_bf16_rounded(a).astype(np.float64))
                                   if a.dtype.kind == "f" else torch.from_numpy(a)
                                   for a in args])
        assert _dtype(got) == str(want.dtype), (what, got.dtype, want.dtype)
        as_exact_as(got.detach(), want, ref.double().numpy())
        checked += 1
    assert checked == 1 + (name != "VAEGAN")


@pytest.mark.parametrize("name", [n for n in KINDS if n != "RAIN_GAN"])
def test_eval_forwards_as_exact_as_jax(name, blob_dataset, bf16):  # noqa: F811
    """`check_eval_forwards` for every trainer but RAIN-GAN (in
    `test_torch_port_bf16_zoo_rain.py`)."""
    check_eval_forwards(name, blob_dataset)


def test_exact_step_runs_without_casts(blob_dataset, bf16, monkeypatch):  # noqa: F811
    """The yardstick is float64 throughout: under `dtype_override(float32)`
    no layer casts, so the exact step's new tensors are float64 (its Adam
    counts int32), and they differ from the policy step's."""
    (run,) = _step_runs("SNGAN", "d", blob_dataset, monkeypatch, [70])
    port, exact = run["port"], run["exact"]
    dtypes = {t.dtype for t in exact._static_tensors()[:-1]}
    assert dtypes <= {torch.float64, torch.int32} and torch.float64 in dtypes
    assert not all(torch.equal(a.double(), b) for a, b in zip(
        port._static_tensors()[:-1], exact._static_tensors()[:-1]) if b.is_floating_point())
