"""`experiments/torch_port_multiseed.py`'s arm tags and `--compare`'s
pairing, on made-up rows (no card, no fit)."""

import importlib.util
import json
import pathlib

import pytest

SCRIPT = pathlib.Path(__file__).parent.parent / "experiments" / "torch_port_multiseed.py"


@pytest.fixture(scope="module")
def study():
    spec = importlib.util.spec_from_file_location("torch_port_multiseed", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_modes_are_tagged_as_the_jax_study_tags_them(study):
    """`--no-warm-start` tags `+fresh_clf`, `--dtype bfloat16` `+bf16`, in
    `experiments/ours_multiseed.py`'s order."""
    assert study.tagged_mode("strict") == "strict"
    assert study.tagged_mode("strict", fresh_clf=True) == "strict+fresh_clf"
    assert study.tagged_mode("balanced", dtype="bfloat16") == "balanced+bf16"
    assert study.tagged_mode("strict", True, "bfloat16") == "strict+fresh_clf+bf16"


def _row(framework, mode, macro_f1, generated):
    return {"framework": framework, "model": "sngan", "seed": 0, "mode": mode,
            "macro_f1": macro_f1, "binary_f1": 0.8, "generated": generated, "needed": 100}


def test_compare_pairs_a_fresh_clf_arm_with_the_jax_one(study, tmp_path):
    """A port `strict+fresh_clf` row is held to the JAX `strict+fresh_clf`
    row, not to the JAX `strict` one beside it; a `+bf16` arm the JAX rows
    lack falls back to its untagged mode."""
    port, jax = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    port.write_text(json.dumps(_row("cvaegan_tpu_torch", "strict+fresh_clf", 0.41, 0)) + "\n")
    jax.write_text(json.dumps(_row("cvaegan_tpu", "strict+fresh_clf", 0.39, 0)) + "\n"
                   + json.dumps(_row("cvaegan_tpu", "strict", 0.14, 50)) + "\n")
    ref = study.read_rows(jax, "cvaegan_tpu")
    ((model, mode, jax_mode, a, b),) = study.paired_arms(
        study.read_rows(port, study.FRAMEWORK), ref)
    assert (model, mode, jax_mode) == ("sngan", "strict+fresh_clf", "strict+fresh_clf")
    assert [r["macro_f1"] for r in a] == [0.41] and [r["macro_f1"] for r in b] == [0.39]
    bf16 = [_row("cvaegan_tpu_torch", "strict+bf16", 0.5, 0)]
    ((_, _, jax_mode, _, b),) = study.paired_arms(bf16, ref)
    assert jax_mode == "strict" and [r["macro_f1"] for r in b] == [0.14]


@pytest.mark.parametrize("gen_mode", ["qualified", "unconditional"])
def test_per_class_counts_sum_to_the_arm_totals(study, gen_mode):
    """Per class, the rows needed (the largest class's count less each
    class's; the train set's counts for the unconditional scheme) and the
    rows generated (the augmented labels' counts less the train set's)
    sum to `needed_rows` and to the rows added; a class the augmented set
    lacks reads 0."""
    import numpy as np

    labels = np.repeat(np.arange(4), [50, 20, 10, 5]).astype(np.int32)
    added = np.repeat(np.arange(3), [0, 30, 7]).astype(np.int32)
    got = study.per_class(labels, np.concatenate([labels, added]), gen_mode)
    assert got["generated_per_class"] == [0, 30, 7, 0]
    assert sum(got["needed_per_class"]) == study.needed_rows(labels, gen_mode)
    want = [50, 20, 10, 5] if gen_mode == "unconditional" else [0, 30, 40, 45]
    assert got["needed_per_class"] == want


def test_summarize_pairs_each_serial_refit_with_its_own_banked_rows(tmp_path, capsys):
    """`experiments/torch_port_jax_cpu_arm.py --summarize` with
    `--port-serial` and `--jax-serial`: each refit is paired by seed with
    the banked rows of its own package (the port's committed rows, the JAX
    package's CPU rows of `--out`), and the two refits are compared."""
    path = SCRIPT.parent / "torch_port_jax_cpu_arm.py"
    spec = importlib.util.spec_from_file_location("torch_port_jax_cpu_arm", path)
    arm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(arm)

    def rows(framework, fit_mode, generated):
        return [{"framework": framework, "model": "rain_gan", "mode": "balanced",
                 "seed": seed, "macro_f1": 0.6, "generated": g, "needed": 100,
                 "fit_mode": fit_mode} for seed, g in zip((10, 11, 12), generated)]

    def write(name, records):
        (tmp_path / name).write_text("".join(json.dumps(r) + "\n" for r in records))
        return tmp_path / name

    out = write("cpu.jsonl", rows("cvaegan_tpu", "bank", [0, 10, 20]))
    jax_serial = write("jax_serial.jsonl", rows("cvaegan_tpu", "serial", [50, 60, 70]))
    port_serial = write("port_serial.jsonl", rows("cvaegan_tpu_torch", "serial", [5, 6, 7]))
    (line,) = arm.summarize(out, port_serial, jax_serial)
    capsys.readouterr()
    got = line["yield"]
    assert line["seeds"]["jax_cpu_serial"] == line["seeds"]["port_serial"] == 3
    assert got["jax_cpu_serial_same_seeds_median"] == 0.6
    assert got["jax_cpu_banked_same_seeds_median"] == 0.1
    assert got["port_serial_same_seeds_median"] == 0.06
    for key in ("p_jax_cpu_serial_jax_cpu_banked_paired", "p_port_serial_port_banked_paired",
                "p_jax_cpu_serial_port_serial"):
        assert 0.0 < got[key] <= 1.0, key
