"""Kernel registry (port of xgpr_tpu/kernels/__init__.py).  Holds the
fixed-vector RBF family and the sequence / graph convolution kernels; the
Linear, MiniARD and SRHT-compressor kernels are not ported yet."""
from .basic import RBF, Matern, Cauchy
from .conv1d import (Conv1dRBF, Conv1dMatern, Conv1dCauchy, GraphRBF,
                     GraphMatern, GraphCauchy)
from .l2_conv1d import Conv1dTwoLayer, FHTMaxpoolConv1dFeatureExtractor

KERNEL_NAME_TO_CLASS = {
    "RBF": RBF,
    "Matern": Matern,
    "Cauchy": Cauchy,
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
