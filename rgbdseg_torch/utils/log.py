"""Logging setup (a copy of `rgbdseg_tpu/utils/log.py::setup_logging`;
reference: utils/log.py:9-26)."""

from __future__ import annotations

import logging
import sys


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        handlers=[logging.StreamHandler(sys.stdout)],
        level=level,
        force=True,  # replace handlers an imported library may have installed
    )
