from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, TrainConfig,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, ALL_SHAPES, SHAPES_BY_NAME,
    get_config, all_configs, register,
)
