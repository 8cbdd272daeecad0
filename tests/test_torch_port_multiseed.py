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
