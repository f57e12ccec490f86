from .config import (QuantizerSpec, QuantMode, QuantConfig, FP, CALIB_W,
                     CALIB_A, WQ, WAQ, DEPLOY, DEPLOY_FUSED, DEPLOY_INT8)
from .affine import (round_ste, lp_loss, calculate_qparams, fake_quant,
                     fake_quant_nograd, qdrop, ema_update)
from .search import (SEARCH_P, ONE_SIDE_UNSET, ONE_SIDE_POS, ONE_SIDE_NEG,
                     ONE_SIDE_NO, detect_one_side, search_range, search_range_1d,
                     search_range_2d, search_range_hist, search_range_1d_hist,
                     search_range_2d_hist, channelwise_view, weight_qparams)
from .adaround import (soft_targets, init_alpha, adaround_fake_quant,
                       round_regularization)

__all__ = ["QuantizerSpec", "QuantMode", "QuantConfig", "FP", "CALIB_W",
           "CALIB_A", "WQ", "WAQ", "DEPLOY", "DEPLOY_FUSED", "DEPLOY_INT8",
           "round_ste", "lp_loss", "calculate_qparams", "fake_quant",
           "fake_quant_nograd", "qdrop", "ema_update", "SEARCH_P",
           "ONE_SIDE_UNSET", "ONE_SIDE_POS", "ONE_SIDE_NEG", "ONE_SIDE_NO",
           "detect_one_side", "search_range", "search_range_1d",
           "search_range_2d", "search_range_hist", "search_range_1d_hist",
           "search_range_2d_hist", "channelwise_view", "weight_qparams",
           "soft_targets", "init_alpha", "adaround_fake_quant",
           "round_regularization"]
