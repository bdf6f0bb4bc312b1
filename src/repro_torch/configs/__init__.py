from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: F401
                                      OptimizerConfig, ParamConfig,
                                      SSMConfig, ShardingConfig, TrainConfig)
