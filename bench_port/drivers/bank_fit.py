"""Driver of the seed-bank cells: repeated `SeedBank.fit` calls.

`replicas` replicas of one trainer class, seeded `seed`, `seed` + 1, ...,
each with its own data set of `frames_per_replica` frames made from its
seed, as the repository's multi-seed study gives each banked replica its
own data. Set-up, window and comparison are the training driver's
(`drivers/fit.py`), for every replica: the reference trains all of them.
"""

from __future__ import annotations

from typing import List

from bench_port.drivers import fit
from bench_port.harness import program


class Driver(fit.Driver):
    span = "bench.bank.fit"

    def seeds(self) -> List[int]:
        return [self.seed + k for k in range(int(self.traffic["replicas"]))]

    def frames(self) -> int:
        return int(self.traffic["frames_per_replica"])

    def _build(self, s) -> None:
        from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank

        bank = SeedBank(program.trainer_class(self.cfg), seeds=self.seeds(), settings=s,
                        device=self.device)
        for t in bank.trainers:
            t.verbose = False
        self.trainers = bank.trainers
        self._fit = lambda data: bank.fit(data)
