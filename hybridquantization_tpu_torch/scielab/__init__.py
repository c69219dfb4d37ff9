"""S-CIELAB filter bank and forward transform."""

from .filters import ScielabFilters, build_filters, samples_per_degree
from .transform import opp_to_scielab, scielab_filter_opp, srgb_to_scielab, stacked_kernels

__all__ = [
    "ScielabFilters",
    "build_filters",
    "samples_per_degree",
    "srgb_to_scielab",
    "scielab_filter_opp",
    "opp_to_scielab",
    "stacked_kernels",
]
