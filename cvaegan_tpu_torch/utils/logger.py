"""Stdlib logger with stream + per-name file handlers, a copy of
`cvaegan_tpu/utils/logger.py` (reference `src/logger.py:6-27`,
`src/config/logging_config.py:3-11`)."""

from __future__ import annotations

import logging

from cvaegan_tpu_torch.core import config as config_lib

STREAM_FORMATTER = logging.Formatter(fmt="[%(name)s] %(levelname)s: %(message)s")
FILE_FORMATTER = logging.Formatter(
    fmt="%(asctime)s [%(name)s] %(levelname)s: %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
)
LEVEL = logging.DEBUG


class Logger(logging.Logger):
    def __init__(self, name: str) -> None:
        super().__init__(name)
        sh = logging.StreamHandler()
        sh.setFormatter(STREAM_FORMATTER)
        sh.setLevel(LEVEL)
        self.addHandler(sh)

        fh = logging.FileHandler(config_lib.settings.paths.logs / f"{name}.log")
        fh.setFormatter(FILE_FORMATTER)
        fh.setLevel(LEVEL)
        self.addHandler(fh)

    def turn_on(self) -> None:
        self.setLevel(LEVEL)
        for handler in self.handlers:
            handler.setLevel(LEVEL)

    def turn_off(self) -> None:
        self.setLevel(logging.CRITICAL + 1)
        for handler in self.handlers:
            handler.setLevel(logging.CRITICAL + 1)
