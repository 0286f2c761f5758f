"""Kernel registry (port of xgpr_tpu/kernels/__init__.py): the
fixed-vector kernels (the RBF family, Linear, MiniARD), the sequence and
graph convolution kernels, and the SRHT compressor."""
from .basic import RBF, Matern, Cauchy, Linear
from .mini_ard import MiniARD
from .conv1d import (Conv1dRBF, Conv1dMatern, Conv1dCauchy, GraphRBF,
                     GraphMatern, GraphCauchy)
from .l2_conv1d import Conv1dTwoLayer, FHTMaxpoolConv1dFeatureExtractor
from .srht_compressor import SRHTCompressor

KERNEL_NAME_TO_CLASS = {
    "RBF": RBF,
    "Matern": Matern,
    "Cauchy": Cauchy,
    "Linear": Linear,
    "MiniARD": MiniARD,
    "Conv1dRBF": Conv1dRBF,
    "Conv1dMatern": Conv1dMatern,
    "Conv1dCauchy": Conv1dCauchy,
    "Conv1dTwoLayer": Conv1dTwoLayer,
    "GraphRBF": GraphRBF,
    "GraphMatern": GraphMatern,
    "GraphCauchy": GraphCauchy,
}

# Kernels that require 3d (N, L, D) input arrays.
ARR_3D_KERNELS = {"GraphRBF", "Conv1dRBF", "Conv1dMatern", "GraphMatern",
                  "GraphCauchy", "Conv1dCauchy", "Conv1dTwoLayer"}
