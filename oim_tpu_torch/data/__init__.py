"""The data plane and the feed (``oim_tpu/data``): the sources (files,
TFRecords, webdataset shards, objects behind an HTTP gateway) and their
extent lowering, the chunked staging pipeline, the host read engines and
the whole-volume token feed."""

from oim_tpu_torch.data.feeds import SeekableFeed, volume_token_batches
from oim_tpu_torch.data.plane import ExtentSource, lower_source, stage_source

__all__ = ["ExtentSource", "SeekableFeed", "lower_source", "stage_source",
           "volume_token_batches"]
