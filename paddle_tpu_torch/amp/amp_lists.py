"""AMP op lists (reference: python/paddle/amp/amp_lists.py).

White list: MXU-bound ops that should run in bf16.  Black list: numerically
sensitive ops kept in f32.
"""

WHITE_LIST = {
    "matmul", "bmm", "mv", "einsum", "conv2d", "conv1d", "conv3d",
    "conv2d_transpose", "flash_attention", "fused_linear",
}

BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax_with_cross_entropy",
    "cross_entropy", "softmax", "log_softmax", "layer_norm", "rms_norm",
    "mean", "sum", "norm", "cumsum", "pow", "sqrt", "rsqrt",
}
