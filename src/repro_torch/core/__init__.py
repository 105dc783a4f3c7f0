"""Core library of the port: factor containers, stage packing, the
symmetric and general fits and their batched facade, the FGFT, the
paper's baselines and the butterfly layers."""
from .types import (GFactors, TFactors, SCALE, SHEAR, gfactors_identity,
                    tfactors_identity)
from .staging import (StagedG, StagedT, default_cut_ladder, pack_g,
                      pack_g_adjoint, pack_g_batch, pack_g_batch_pair,
                      pack_g_pair, pack_t, pack_t_batch, pack_t_batch_pair,
                      pack_t_inverse, pack_t_pair, select_cut, table_arrays,
                      truncate_staged)
from .gtransform import (approximate_symmetric, default_sbar, g_init,
                         g_objective, g_polish, g_to_dense, gapply,
                         lemma1_spectrum)
from .ttransform import (approximate_general, default_cbar, lemma2_spectrum,
                         t_init, t_objective, t_polish, t_reconstruct,
                         t_to_dense, tapply)
from .eigenbasis import ApproxEigenbasis, pad_ragged
from .fgft import (FGFT, build_fgft, laplacian, prefix_relative_error,
                   relative_error)
from .baselines import (factorize_orthonormal, rank_r_general,
                        rank_r_symmetric, truncated_jacobi)
from .fastlinear import (ButterflyParams, ButterflyPattern, CompressedLinear,
                         butterfly_apply, butterfly_init, compress_linear,
                         compressed_linear_apply, fft_pattern)
