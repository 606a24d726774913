from .binning import PHASE_THRESHOLDS, RADIUS_THRESHOLDS, threshold_analysis_ssm
from .eval_eig import eval_eig
from .extractors import eig_lru

__all__ = ["PHASE_THRESHOLDS", "RADIUS_THRESHOLDS", "eig_lru", "eval_eig", "threshold_analysis_ssm"]
