from ._build import LAUNCHES
from .scan import diag_linear_scan, diag_scan_cuda, diag_scan_plain

__all__ = ["LAUNCHES", "diag_linear_scan", "diag_scan_cuda", "diag_scan_plain"]
