"""Auto-checkpoint (the port's copy of
``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``) — parity with fluid/incubate/checkpoint/
auto_checkpoint.py (`TrainEpochRange`:267 wraps the epoch loop, snapshots
state per epoch keyed by job id, and transparently resumes after a
relaunch; the reference writes to HDFS via checkpoint_saver.py, here to the
sharded local/NFS checkpoint layout).
"""
from __future__ import annotations

import os

from ...framework.checkpoint import AsyncCheckpointSaver


def _job_id() -> str:
    return os.environ.get("PADDLE_JOB_ID",
                          os.environ.get("PADDLE_ELASTIC_JOB_ID", "default"))


def _root_dir() -> str:
    return os.environ.get("PADDLE_AUTO_CHECKPOINT_DIR",
                          os.path.join(".", "auto_checkpoint"))


class TrainEpochRange:
    """for epoch in TrainEpochRange(E, name): ...  — saves registered
    model/optimizer state at each epoch end and resumes from the last saved
    epoch after a restart (auto_checkpoint.py:267/:636)."""

    def __init__(self, max_epoch_num: int, name: str | None = None,
                 save_checkpoint_inter: int = 1, checkpoint_dir=None,
                 keep_last: int = 3, fs=None):
        self.max_epoch_num = max_epoch_num
        self.name = name or _job_id()
        self.save_inter = max(1, save_checkpoint_inter)
        base = checkpoint_dir or os.path.join(_root_dir(), self.name)
        # fs: a fleet.utils.fs client; HDFS/GCS checkpoints stage through
        # a local temp dir (reference auto_checkpoint.py:636 fs plumbing)
        self._saver = AsyncCheckpointSaver(base, keep_last=keep_last, fs=fs)
        self._registered = []  # (obj with state_dict/set_state_dict, tag)
        self._start_epoch = 0
        self._restored_state = None
        # restore_latest_valid: a corrupt/torn newest epoch falls back to
        # the previous committed one instead of failing the relaunch
        last, state = self._saver.restore_latest_valid()
        if last is not None:
            self._restored_state = state
            self._start_epoch = last + 1

    # -- registration (reference: exe/program snapshot; here state_dicts) ----
    def register(self, obj, tag: str | None = None):
        tag = tag or f"obj{len(self._registered)}"
        self._registered.append((obj, tag))
        if self._restored_state is not None and tag in self._restored_state:
            obj.set_state_dict(self._restored_state[tag])
        return self

    @property
    def start_epoch(self) -> int:
        return self._start_epoch

    def __iter__(self):
        for epoch in range(self._start_epoch, self.max_epoch_num):
            yield epoch
            if (epoch + 1) % self.save_inter == 0 or \
                    epoch == self.max_epoch_num - 1:
                self._snapshot(epoch)
        self._saver.wait()

    def _snapshot(self, epoch: int):
        state = {tag: obj.state_dict() for obj, tag in self._registered}
        self._saver.save(state, step=epoch)

    def save_checkpoint(self, epoch: int | None = None):
        self._snapshot(epoch if epoch is not None else self._start_epoch)
        self._saver.wait()


def train_epoch_range(max_epoch_num, save_checkpoint_inter=1):
    """auto_checkpoint.train_epoch_range generator parity."""
    r = TrainEpochRange(max_epoch_num,
                        save_checkpoint_inter=save_checkpoint_inter)
    yield from r
