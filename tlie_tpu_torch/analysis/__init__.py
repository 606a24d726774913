from .binning import PHASE_THRESHOLDS, RADIUS_THRESHOLDS, threshold_analysis, threshold_analysis_ssm
from .eval_eig import eval_eig
from .extractors import (
    eig_att_linear, eig_att_norm, eig_att_softmax, eig_lru, eig_mamba1, eig_mamba2,
    eig_mamba2_lti,
)

__all__ = ["PHASE_THRESHOLDS", "RADIUS_THRESHOLDS", "eig_att_linear", "eig_att_norm",
           "eig_att_softmax", "eig_lru", "eig_mamba1", "eig_mamba2", "eig_mamba2_lti",
           "eval_eig", "threshold_analysis", "threshold_analysis_ssm"]
