"""The bf16-operand block-attention kernels (B2/B3 on bf16 q, k, v) timed
on the card beside those of other checkouts.

Builds this tree's bf16 kernel (`cvaegan_tpu_torch/csrc/
block_attention_sm90.cu`) and, for each `--old-tree DIR` (a checkout of
another commit, e.g. `git archive <commit> | tar -x -C _checkout/parent`),
that tree's bf16 kernel. Holds each to the plain version as
`chip_smoke.py::bf16_attention_vs_plain` does, then prints one JSON line
of CUDA-event medians (`chip_smoke.py::cuda_ms`, every kernel in the same
rounds) of B2 and B3 at `[128, 1024, d]` for d 64 (T1), 32, 16 and 128,
beside the bound (`chip_smoke.py::attention_bound_bf16`).

    python experiments/torch_port_bf16_attention.py --old-tree _checkout/parent

Needs a card; imports no JAX. `chip_smoke.py` reports this tree's build
(ptxas, SASS) and times the plain versions and SDPA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import types

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (its helpers; it runs nothing on import)

SHAPES = (("t1", chip_smoke.T1[0] * chip_smoke.HEADS, 64), ("d32", 32 * chip_smoke.HEADS, 32),
          ("d16", 32 * chip_smoke.HEADS, 16), ("d128", 32 * chip_smoke.HEADS, 128))


def build_other(tree: pathlib.Path):
    """Compiles another tree's bf16 kernel with this tree's flags into that
    tree's `_build/`: its `csrc/block_attention_sm90.cu` (entry
    `block_attention_sm90_bf16`) where it has one, else its
    `csrc/block_attention.cu` (entry `block_attention_bf16`, the `mma.sync`
    kernel before it). Returns (library, entry)."""
    from cvaegan_tpu_torch.kernels import _build

    csrc = tree / "cvaegan_tpu_torch" / "csrc"
    if (csrc / "block_attention_sm90.cu").exists():
        source, entry = "block_attention_sm90.cu", "block_attention_sm90_bf16"
    else:
        source, entry = "block_attention.cu", "block_attention_bf16"
    out = tree / "cvaegan_tpu_torch" / "_build" / f"{tree.name}_{pathlib.Path(source).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(csrc / source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {tree}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), entry


def kernels_of(torch, ba, lib, entry):
    """B2 and B3 through one library's C entry, with the plain version and
    the rule beside them: what `bf16_attention_vs_plain` takes as `ba`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [p] * 5 + [i] * 3 + [p]
    fn.restype = i
    lib.block_attention_error_string.argtypes = [i]
    lib.block_attention_error_string.restype = ctypes.c_char_p

    def launch(q, k, v, with_entropy):
        bh, seq, d = q.shape
        out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
        ent = torch.empty((bh, seq), device=q.device, dtype=torch.float32) \
            if with_entropy else None
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if ent is None else ent.data_ptr(), bh, seq, d,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(lib.block_attention_error_string(rc).decode())
        return out, ent

    return types.SimpleNamespace(
        block_attention=lambda q, k, v: launch(q, k, v, False)[0],
        block_attention_with_entropy=lambda q, k, v: launch(q, k, v, True),
        block_attention_with_entropy_reference=ba.block_attention_with_entropy_reference,
        float64_rule=ba.float64_rule)


def timing(torch, kernels, part):
    out = {}
    g = torch.Generator(device="cuda").manual_seed(3)
    for name, bh, d in SHAPES:
        q, k, v = (torch.randn(bh, 1024, d, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        fns, keys = [], []
        for which, kern in kernels.items():
            fns += [lambda kern=kern: kern.block_attention(q, k, v),
                    lambda kern=kern: kern.block_attention_with_entropy(q, k, v)]
            keys += [f"b2_{which}_ms", f"b3_{which}_ms"]
        with torch.no_grad():
            times, rounds = chip_smoke.cuda_ms(torch, fns, iters=20, reps=6, warmup=3)
        out[name] = {"shape": [bh, 1024, d], **dict(zip(keys, times)),
                     "rounds": dict(zip(keys, rounds)),
                     "b2_bound": chip_smoke.attention_bound_bf16(part, bh, 1024, d, False),
                     "b3_bound": chip_smoke.attention_bound_bf16(part, bh, 1024, d, True)}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old-tree", type=pathlib.Path, action="append", default=[],
                   help="checkout of another commit whose bf16 kernel is checked and timed "
                        "beside this tree's (repeatable; named by its directory)")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_port_bf16_attention: CUDA is not available", file=sys.stderr)
        return 1
    from cvaegan_tpu_torch.kernels import block_attention as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi("name,power.limit")
    part, _ = chip_smoke.peaks_for(card)
    kernels = {"new": kernels_of(torch, ba, ba.build(torch.bfloat16), ba.ENTRIES[torch.bfloat16])}
    for tree in args.old_tree:
        kernels[tree.name] = kernels_of(torch, ba, *build_other(tree))
    checks = {which: chip_smoke.bf16_attention_vs_plain(torch, kern, torch.device("cuda"))
              for which, kern in kernels.items()}
    worst = max(r for stats in checks.values() for groups in stats.values()
                for _, r in groups.values())
    print(json.dumps({"phase": "check", "card": card, "tol": chip_smoke.ATTN_TOL,
                      "scale10_rule": "float64_rule", "err_and_ratio": checks}), flush=True)
    print(json.dumps({"phase": "timing", "card": card, "peaks_of": part,
                      **timing(torch, kernels, part)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": worst <= 1.0, "worst_ratio": worst}), flush=True)
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
