"""paddle.reader — legacy reader-composition namespace (the port's copy of
``paddle_tpu/reader``; reference: python/paddle/reader/decorator.py).  A "reader" is a zero-arg callable
returning an iterator of samples; these decorators compose readers the
way the pre-DataLoader recipes did."""
from .decorator import (buffered, cache, chain, compose,  # noqa: F401
                        firstn, map_readers, multiprocess_reader, shuffle,
                        xmap_readers)

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader"]
