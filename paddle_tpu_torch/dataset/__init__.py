"""paddle.dataset — the LEGACY reader-creator dataset namespace
(reference: python/paddle/dataset/): `paddle.dataset.mnist.train()`
returns a zero-arg callable yielding samples, composable with
paddle.reader decorators.  The port's copy of ``paddle_tpu/dataset``
(host-side Python and numpy).  Each module delegates to the new-style
Dataset classes (paddle.vision.datasets / paddle.text.datasets); this
build has no network egress, so the readers take explicit local file
paths where the reference would download."""
from . import (cifar, common, conll05, flowers, image,  # noqa: F401
               imdb, imikolov, mnist, movielens, uci_housing, voc2012,
               wmt14, wmt16)

__all__ = ["mnist", "cifar", "flowers", "uci_housing", "imdb", "imikolov",
           "movielens", "conll05", "wmt14", "wmt16", "voc2012", "common",
           "image"]
