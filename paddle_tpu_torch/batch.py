"""paddle.batch — reader batching (the port's copy of
``paddle_tpu/batch.py``; reference python/paddle/batch.py:18)."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader into a batched reader yielding lists of up to
    `batch_size` samples (drop_last drops the ragged tail)."""
    if batch_size <= 0 or batch_size != int(batch_size):
        raise ValueError(
            "batch_size should be a positive integer value, "
            f"but got batch_size={batch_size}")

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
