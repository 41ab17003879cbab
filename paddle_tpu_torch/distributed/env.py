"""The launcher's environment (``paddle_tpu.parallel.env`` counterpart):
rank and world size from the variables a launcher sets, else a single
process (the port has no multi-process runtime yet, ROADMAP module item
11)."""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size"]


def get_rank() -> int:
    for key in ("PADDLE_TRAINER_ID", "PADDLE_RANK", "RANK"):
        if key in os.environ:
            return int(os.environ[key])
    return 0


def get_world_size() -> int:
    for key in ("PADDLE_TRAINERS_NUM", "PADDLE_WORLD_SIZE", "WORLD_SIZE"):
        if key in os.environ:
            return int(os.environ[key])
    return 1
