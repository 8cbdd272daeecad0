"""The Car-Hacking stand-in the benchmark trains and balances on.

A frozen copy of `scripts/prepare_can_dataset.py::synthetic_car_hacking`
(numpy only) and of the port's column-wise min-max scaling, so that no
later change to the program or its scripts moves the benchmark's data.
`frames(n, seed)` gives the scaled features `[n, 10]` (CAN ID, DLC, 8
data bytes) and the labels `[n]` (0 normal, 1 DoS, 2 fuzzy, 3 gear,
4 RPM) at the published class proportions.
"""

import numpy as np


# ---------------------------------------------------------------------------
# Schema-faithful Car-Hacking stand-in
# ---------------------------------------------------------------------------
# Published figures from the HCRL Car-Hacking dataset description
# (Seo/Song/Kim 2018, the corpus the reference's loader names,
# `src/datasets/__init__.py:9` of the reference): per-capture frame totals,
# injected-frame counts, injected IDs, and injection intervals. The real
# captures are not shipped with the repository; this generator
# reproduces the published SCHEMA (timestamp-ordered 11-bit CAN ID + DLC +
# 8 data bytes), the published CLASS PROPORTIONS, and the published
# TIME-CLUSTERED burst structure (attacks injected in 3-5 s bursts into
# otherwise-normal periodic bus traffic) so scale/streaming experiments
# exercise the same data shape the reference was built around.
CAR_HACKING_PUBLISHED = {
    # capture: (total frames, injected frames)
    "dos": {"total": 3_665_771, "injected": 587_521,
            "inject_id": 0x000, "interval_ms": 0.3},
    "fuzzy": {"total": 3_838_860, "injected": 491_847,
              "inject_id": None, "interval_ms": 0.5},   # random ID
    "gear": {"total": 4_443_142, "injected": 597_252,
             "inject_id": 0x43F, "interval_ms": 1.0},
    "rpm": {"total": 4_621_702, "injected": 654_897,
            "inject_id": 0x316, "interval_ms": 1.0},
    "attack_free_total": 988_987,
}
# Class order used throughout the framework's CAN pipelines.
CAR_HACKING_CLASSES = ("normal", "dos", "fuzzy", "gear", "rpm")


def car_hacking_proportions():
    """Published per-class frame proportions over the merged corpus."""
    pub = CAR_HACKING_PUBLISHED
    total = sum(pub[k]["total"] for k in ("dos", "fuzzy", "gear", "rpm"))
    total += pub["attack_free_total"]
    props = {k: pub[k]["injected"] / total
             for k in ("dos", "fuzzy", "gear", "rpm")}
    props["normal"] = 1.0 - sum(props.values())
    return props  # normal 0.8672, dos 0.0335, fuzzy 0.0280, gear 0.0340, rpm 0.0373


def synthetic_car_hacking(n_frames=100_000, seed=0, bus_rate_hz=2000.0):
    """Schema/proportion-faithful Car-Hacking stand-in.

    Returns (x [n,10] float32, y [n] int64, meta dict). x rows are
    TIME-ORDERED frames (can_id, dlc, d0..d7) exactly as
    `scripts/prepare_can_dataset.py::load_class_file` extracts from the real captures; y is the per-frame
    class (0=normal, then the CAR_HACKING_CLASSES order).

    Faithful structure:
      * normal traffic: 26 periodic IDs (the real normal capture carries
        ~26 unique arbitration IDs) with per-ID cycle times, mostly-static
        payloads, a rolling counter byte and one noisy signal byte;
      * attack bursts of 3-5 s injected into the normal stream at the
        published per-attack injection interval (DoS 0.3 ms floods ID
        0x000/zero payload; fuzzy 0.5 ms random ID+payload; gear/RPM
        spoofs 1 ms at fixed IDs 0x43F/0x316 with plausible payloads) —
        normal periodic traffic CONTINUES through each burst;
      * burst counts sized so final class proportions match the published
        corpus-wide proportions (meta reports the achieved mix).
    """
    rng = np.random.default_rng(seed)
    props = car_hacking_proportions()
    dt_normal = 1.0 / bus_rate_hz

    # Normal bus model: 26 periodic IDs, plausible 11-bit values.
    n_ids = 26
    id_pool = np.sort(rng.choice(np.arange(0x080, 0x700), n_ids,
                                 replace=False)).astype(np.int64)
    id_dlc = rng.choice([2, 4, 5, 6, 7, 8], n_ids,
                        p=[.05, .1, .1, .1, .15, .5])
    base_payload = rng.integers(0, 256, (n_ids, 8))
    counter_byte = rng.integers(0, 8, n_ids)    # rolling-counter position
    signal_byte = rng.integers(0, 8, n_ids)     # noisy-signal position
    # relative frequency of each periodic ID (some IDs are much chattier)
    id_weight = rng.dirichlet(np.ones(n_ids) * 2.0)

    def normal_frames(n):
        idx = rng.choice(n_ids, n, p=id_weight)
        counters = rng.integers(0, 256, n)  # free-running per-frame
        data = base_payload[idx].copy()
        data[np.arange(n), counter_byte[idx]] = counters % 256
        data[np.arange(n), signal_byte[idx]] = np.clip(
            rng.normal(128, 25, n), 0, 255).astype(np.int64)
        dlc = id_dlc[idx]
        mask = np.arange(8)[None, :] < dlc[:, None]
        data = np.where(mask, data, 0)
        return np.column_stack([id_pool[idx], dlc, data])

    def attack_frames(kind, n):
        spec = CAR_HACKING_PUBLISHED[kind]
        if kind == "dos":
            ids = np.zeros(n, np.int64)
            data = np.zeros((n, 8), np.int64)
        elif kind == "fuzzy":
            ids = rng.integers(0, 0x800, n)
            data = rng.integers(0, 256, (n, 8))
        elif kind == "gear":
            ids = np.full(n, spec["inject_id"], np.int64)
            data = np.tile(rng.integers(0, 256, 8), (n, 1))
            data[:, 3] = rng.integers(0, 6, n) * 32  # spoofed gear value
        else:  # rpm
            ids = np.full(n, spec["inject_id"], np.int64)
            data = np.tile(rng.integers(0, 256, 8), (n, 1))
            rpmv = rng.integers(0x3000, 0x4000, n)   # spoofed high RPM
            data[:, 2] = rpmv >> 8
            data[:, 3] = rpmv & 0xFF
        return np.column_stack([ids, np.full(n, 8, np.int64), data])

    # Burst plan: per attack, enough 3-5 s bursts at its injection rate
    # to reach the published proportion of n_frames.
    segments = []  # (kind, n_attack_frames) or ("normal", n)
    for ci, kind in enumerate(("dos", "fuzzy", "gear", "rpm")):
        need = int(round(props[kind] * n_frames))
        rate = 1000.0 / CAR_HACKING_PUBLISHED[kind]["interval_ms"]
        bursts = []
        while need > 0:
            dur = rng.uniform(3.0, 5.0)
            k = min(need, int(dur * rate))
            bursts.append((kind, k))
            need -= k
        segments.extend(bursts)
    rng.shuffle(segments)

    # Interleave: during each burst, normal periodic traffic CONTINUES at
    # the bus rate alongside the injected frames. That background traffic
    # is part of the normal-frame budget, so the normal gaps between
    # bursts get what remains — total frame count and class proportions
    # come out exact (no tail trim that could swallow a burst).
    n_attack = sum(k for _, k in segments)
    bg_sizes = [
        int(k * CAR_HACKING_PUBLISHED[kind]["interval_ms"] / 1000.0
            / dt_normal)
        for kind, k in segments
    ]
    n_gaps_total = n_frames - n_attack - sum(bg_sizes)
    if n_gaps_total < len(segments) + 1:
        raise ValueError(
            f"n_frames={n_frames} too small for the burst plan "
            f"({n_attack} attack + {sum(bg_sizes)} in-burst background "
            "frames); use more frames")
    gap_sizes = rng.multinomial(
        n_gaps_total - len(segments) - 1,
        np.ones(len(segments) + 1) / (len(segments) + 1)) + 1

    xs, ys = [], []
    label_of = {k: i for i, k in enumerate(CAR_HACKING_CLASSES)}
    for i, (kind, k) in enumerate(segments):
        g = int(gap_sizes[i])
        xs.append(normal_frames(g))
        ys.append(np.zeros(g, np.int64))
        n_bg = bg_sizes[i]
        bx = np.concatenate([attack_frames(kind, k), normal_frames(n_bg)])
        by = np.concatenate([np.full(k, label_of[kind], np.int64),
                             np.zeros(n_bg, np.int64)])
        order = rng.permutation(len(bx))
        xs.append(bx[order])
        ys.append(by[order])
    g = int(gap_sizes[-1])
    xs.append(normal_frames(g))
    ys.append(np.zeros(g, np.int64))

    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    achieved = {k: float((y == i).mean())
                for i, k in enumerate(CAR_HACKING_CLASSES)}
    meta = {
        "schema": ["can_id", "dlc"] + [f"d{i}" for i in range(8)],
        "classes": list(CAR_HACKING_CLASSES),
        "published_proportions": {k: round(v, 4)
                                  for k, v in props.items()},
        "achieved_proportions": {k: round(v, 4)
                                 for k, v in achieved.items()},
        "n_frames": int(len(y)),
        "n_bursts": len(segments),
        "burst_seconds": [3.0, 5.0],
        "seed": seed,
    }
    return x, y, meta


def minmax_scale(x: np.ndarray) -> np.ndarray:
    """Column-wise min-max to [0, 1]; constant columns map to 0."""
    lo = x.min(axis=0, keepdims=True)
    hi = x.max(axis=0, keepdims=True)
    span = np.where(hi - lo == 0.0, 1.0, hi - lo)
    return ((x - lo) / span).astype(np.float32)


def frames(n_frames: int, seed: int):
    """(x [n, 10] float32 in [0, 1], y [n] int32): `n_frames` stand-in
    frames drawn from `seed`, min-max scaled."""
    x, y, _ = synthetic_car_hacking(n_frames, seed=seed)
    return minmax_scale(x), y.astype(np.int32)


def distinct(x: np.ndarray, seed: int) -> np.ndarray:
    """`x` with every feature moved by less than half a byte's step
    (uniform on +-0.5/255, drawn from `seed`): the same frames, but no two
    rows alike. A strict batch of DoS frames (ID 0x000, zero payload) is
    one row 128 times, and a BatchNorm over it normalises rounding alone;
    the steps that the comparison follows are fed these rows instead."""
    rng = np.random.default_rng([int(seed), 1])
    return (x + (rng.random(x.shape, dtype=np.float32) - 0.5) / 255.0).astype(np.float32)
