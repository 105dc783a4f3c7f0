"""Core library of the port: factor containers, stage packing, the
symmetric fit and its batched facade, and the undirected FGFT."""
from .types import GFactors, TFactors, SCALE, SHEAR, gfactors_identity
from .staging import (StagedG, default_cut_ladder, pack_g, pack_g_adjoint,
                      pack_g_batch, pack_g_batch_pair, pack_g_pair,
                      select_cut, table_arrays, truncate_staged)
from .gtransform import (approximate_symmetric, default_sbar, g_init,
                         g_objective, g_polish, g_to_dense, gapply,
                         lemma1_spectrum)
from .eigenbasis import ApproxEigenbasis
from .fgft import (FGFT, build_fgft, laplacian, prefix_relative_error,
                   relative_error)
