"""The data plane and the feed (``oim_tpu/data``): extent lowering, the
chunked staging pipeline, host reads and the whole-volume token feed."""

from oim_tpu_torch.data.feeds import SeekableFeed, volume_token_batches
from oim_tpu_torch.data.plane import ExtentSource, lower_source, stage_source

__all__ = ["ExtentSource", "SeekableFeed", "lower_source", "stage_source",
           "volume_token_batches"]
