"""Spectrum refresh of the dynamic subsystem (the Lemma-1 refits the
tiered server runs); drift scoring and the refit controller are later
slices of the port."""
from .refit import lemma1_refresh, prefix_spectrum
