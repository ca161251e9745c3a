"""The data plane and the feed (``oim_tpu/data``): the sources (files,
TFRecords, webdataset shards, objects behind an HTTP gateway) and their
extent lowering, the chunked staging pipeline, the host read engines and
the feeds: a staged volume's tokens gathered whole, and a volume published
through the feeder, whole or in windows."""

from oim_tpu_torch.data.feeds import (
    SeekableFeed,
    feeder_batches,
    volume_token_batches,
    windowed_batches,
)
from oim_tpu_torch.data.plane import ExtentSource, lower_source, stage_source

__all__ = ["ExtentSource", "SeekableFeed", "feeder_batches", "lower_source",
           "stage_source", "volume_token_batches", "windowed_batches"]
