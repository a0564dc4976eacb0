from .emd import emd_1d, emd_shape_loss, normalize_profile, resample_profile
from .host_oracle import compare_peak_sets, peak_matching_loss
from .legacy import DiffractionPipeline, naive_rebin, scalar_peak_matching_loss
from .metrics import DiffractionMetricsCalculator
from .peaks import extract_peak_region, find_peaks_for_batch
from .qwrapper import Qwrapper, centers_to_edges, d_centers_hr, d_centers_lr, make_d_grid

__all__ = [
    "Qwrapper",
    "d_centers_lr",
    "d_centers_hr",
    "make_d_grid",
    "centers_to_edges",
    "find_peaks_for_batch",
    "extract_peak_region",
    "emd_1d",
    "emd_shape_loss",
    "normalize_profile",
    "resample_profile",
    "compare_peak_sets",
    "peak_matching_loss",
    "DiffractionMetricsCalculator",
    "DiffractionPipeline",
    "scalar_peak_matching_loss",
    "naive_rebin",
]
