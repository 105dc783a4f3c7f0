"""Graph spectral operations served through the batched FGFT engine:
filter banks (filters.py) dispatched through the hand-written bank
kernels (kernels/spectral.py), top-k coefficient compression
(compress.py) and the Chebyshev matched-flops baseline (chebyshev.py)."""
from .filters import (RESPONSES, Response, SpectralFilter,
                      SpectralFilterBank, bandpass, hammond_bank,
                      hammond_kernel, heat, highpass, lowpass,
                      named_responses, response_lipschitz, tikhonov,
                      wavelet_scales)
from .compress import (Compressed, compress, compression_error,
                       topk_coefficients)
from .chebyshev import (chebyshev_apply, chebyshev_coefficients,
                        chebyshev_filter, estimate_lmax, matched_degree)
