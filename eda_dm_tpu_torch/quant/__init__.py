from .config import (QuantizerSpec, QuantMode, QuantConfig, FP, DEPLOY,
                     DEPLOY_FUSED, DEPLOY_INT8)
from .affine import calculate_qparams, fake_quant, fake_quant_nograd
from .search import (SEARCH_P, ONE_SIDE_UNSET, ONE_SIDE_POS, ONE_SIDE_NEG,
                     ONE_SIDE_NO, detect_one_side, search_range, search_range_1d,
                     search_range_2d, search_range_hist, search_range_1d_hist,
                     search_range_2d_hist, channelwise_view, weight_qparams)

__all__ = ["QuantizerSpec", "QuantMode", "QuantConfig", "FP", "DEPLOY",
           "DEPLOY_FUSED", "DEPLOY_INT8", "calculate_qparams", "fake_quant",
           "fake_quant_nograd", "SEARCH_P", "ONE_SIDE_UNSET", "ONE_SIDE_POS",
           "ONE_SIDE_NEG", "ONE_SIDE_NO", "detect_one_side", "search_range",
           "search_range_1d", "search_range_2d", "search_range_hist",
           "search_range_1d_hist", "search_range_2d_hist", "channelwise_view",
           "weight_qparams"]
