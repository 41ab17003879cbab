"""paddle.io parity surface (``paddle_tpu.io`` counterpart): datasets,
samplers, the DataLoader (forked workers over the shared-memory ring) and
the ``DevicePrefetcher`` (pinned staging and a copy stream)."""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, WeightedRandomSampler,
    BatchSampler, DistributedBatchSampler,
)
from .dataloader import DataLoader, get_worker_info, default_collate_fn  # noqa: F401
from .prefetch import DevicePrefetcher  # noqa: F401
