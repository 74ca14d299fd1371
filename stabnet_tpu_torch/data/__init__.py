"""Data: synthetic clips and examples, records, augmentation and the input
pipeline (PyTorch port of stabnet_tpu.data)."""

from stabnet_tpu_torch.data.augment import (
    AugParams,
    Draws,
    augment_batch,
    augment_example,
    augment_with,
    draw_augmentation,
    draw_params,
    prepare_raw,
)
from stabnet_tpu_torch.data.pipeline import InputPipeline, batch_iterator, prefetch
from stabnet_tpu_torch.data.records import (
    SHARD_KEYS,
    iterate_examples,
    list_shards,
    read_shard,
    write_shards,
    write_synthetic_dataset,
)
from stabnet_tpu_torch.data.synthetic import (
    make_raw_batch,
    make_raw_example,
    make_video,
    to_gray_train,
)
