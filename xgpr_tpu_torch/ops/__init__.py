"""Feature ops (the namesakes of xgpr_tpu.ops, the same 23 names); the
CUDA kernels and their wrappers live in ops/cuda, and importing this
package builds none of them (they are built at their first launch)."""
from .hadamard import fwht, fwht_normalized, hadamard_matrix, next_pow2
from .sorf import (sorf_blocks, sorf_project, rbf_feature_map,
                   rbf_feature_map_grad, srht_rows, rbf_norm_constant,
                   cos_sin_features, pad_rows)
from .layout import (assemble_cos_sin, freq_positions,
                     variance_column_indices, block_widths)
from .conv import (conv_rbf_features, conv_maxpool_features,
                   SCALING_NONE, SCALING_SQRT, SCALING_FULL)
from .ard import precompute_sorf_weights, mini_ard_grad
