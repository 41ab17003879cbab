"""``paddle_tpu.distributed.fleet.utils`` counterparts: the filesystem
clients the checkpoint saver writes through (:mod:`fs`)."""
from . import fs  # noqa: F401
from .fs import (ExecuteError, FS, FSFileNotExistsError,  # noqa: F401
                 GCSClient, HDFSClient, LocalFS)
