"""``paddle_tpu.distributed.fleet.utils`` counterparts: the filesystem
clients the checkpoint saver writes through (:mod:`fs`) and
:class:`HybridParallelInferenceHelper` at one rank."""
from . import fs  # noqa: F401
from .fs import (ExecuteError, FS, FSFileNotExistsError,  # noqa: F401
                 GCSClient, HDFSClient, LocalFS)
from .hybrid_parallel_inference import \
    HybridParallelInferenceHelper  # noqa: F401
