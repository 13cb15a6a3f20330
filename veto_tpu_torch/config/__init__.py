from .defaults import (
    Config,
    DataConfig,
    DetectorConfig,
    EnsembleConfig,
    RelationConfig,
    SolverConfig,
    TestConfig,
    VetoTransformerConfig,
    load_config,
)

__all__ = [
    "Config",
    "DataConfig",
    "DetectorConfig",
    "EnsembleConfig",
    "RelationConfig",
    "SolverConfig",
    "TestConfig",
    "VetoTransformerConfig",
    "load_config",
]
