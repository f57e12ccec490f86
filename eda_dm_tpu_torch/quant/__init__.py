from .config import (QuantizerSpec, QuantMode, QuantConfig, FP, DEPLOY,
                     DEPLOY_INT8)

__all__ = ["QuantizerSpec", "QuantMode", "QuantConfig", "FP", "DEPLOY",
           "DEPLOY_INT8"]
