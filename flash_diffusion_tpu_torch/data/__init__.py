"""The data pipeline of the PyTorch port: tar shards, filters, mappers,
collation and prefetch (port of ``flash_diffusion_tpu/data``; aspect
bucketing, the native JPEG decoder and the Canny and depth mappers are not
ported)."""

from .collation import custom_collation_fn
from .dataset import (
    DataModule,
    DataModuleConfig,
    DataPipeline,
    expand_shards,
    iter_tar_samples,
    prefetch_to_device,
)
from .filters import (
    BaseFilter,
    FilterOnCondition,
    FilterOnConditionConfig,
    FilterWrapper,
    KeyFilter,
    KeyFilterConfig,
)
from .mappers import (
    BaseMapper,
    ImageTransformMapper,
    ImageTransformMapperConfig,
    KeyRenameMapper,
    KeyRenameMapperConfig,
    KeysFromJSONMapper,
    KeysFromJSONMapperConfig,
    MapperWrapper,
    RemoveKeysMapper,
    RemoveKeysMapperConfig,
    RescaleMapper,
    RescaleMapperConfig,
    SelectKeysMapper,
    SelectKeysMapperConfig,
    SetValueMapper,
    SetValueMapperConfig,
)

__all__ = [
    "BaseFilter",
    "BaseMapper",
    "DataModule",
    "DataModuleConfig",
    "DataPipeline",
    "FilterOnCondition",
    "FilterOnConditionConfig",
    "FilterWrapper",
    "ImageTransformMapper",
    "ImageTransformMapperConfig",
    "KeyFilter",
    "KeyFilterConfig",
    "KeyRenameMapper",
    "KeyRenameMapperConfig",
    "KeysFromJSONMapper",
    "KeysFromJSONMapperConfig",
    "MapperWrapper",
    "RemoveKeysMapper",
    "RemoveKeysMapperConfig",
    "RescaleMapper",
    "RescaleMapperConfig",
    "SelectKeysMapper",
    "SelectKeysMapperConfig",
    "SetValueMapper",
    "SetValueMapperConfig",
    "custom_collation_fn",
    "expand_shards",
    "iter_tar_samples",
    "prefetch_to_device",
]
