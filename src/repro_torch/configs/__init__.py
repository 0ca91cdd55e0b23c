from .base import (ArchConfig, EncDecCfg, FrontendStub, MoECfg, SHAPES, SSMCfg,
                   ShapeCfg, XLSTMCfg, cell_supported, input_specs)
from .registry import ARCH_IDS, config, smoke_config

__all__ = [
    "ArchConfig", "EncDecCfg", "FrontendStub", "MoECfg", "SHAPES", "SSMCfg",
    "ShapeCfg", "XLSTMCfg", "cell_supported", "input_specs",
    "ARCH_IDS", "config", "smoke_config",
]
