"""gluon.data — datasets, samplers, dataloaders (counterpart of
``mxnet_tpu/gluon/data``)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler, FilterSampler, IntervalSampler,
                      FixedBucketSampler)
from .dataloader import DataLoader, default_batchify_fn
from . import vision
