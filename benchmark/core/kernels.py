"""Kernel names of the port, as the profiler reports them, by layer.

The conv templates of ``csrc/ae_conv.cuh`` serve both libraries; in a
serving cell only the AE stages launch them, in a training cell only the
training step (validation runs the module on cuDNN's kernels), so a cell's
kind tells the two apart.
"""

CONV_TEMPLATES = (r"\b(conv_in_mma_kernel|conv_igemm_kernel|convt_igemm_kernel|"
                  r"conv_out_mma_kernel|conv_quad_kernel|convt_relu_kernel)\b")
# K1's layer (ops/stft_fused.py): the STFT kernel, then the normalization
# in torch's own kernels (the min and max over the kernel's partial ones,
# the subtraction and the division); in a serving cell nothing else of the
# port launches a torch kernel (the AE stages are all ae.cu's)
K1 = r"\bstft_logpsd_kernel\b|\bat::native::"
AE_STAGES = CONV_TEMPLATES
TRAIN_STEP = (r"\b(wgrad_kernel|convt_dgrad_kernel|sum_rows_kernel|conv_in_mma_kernel|"
              r"conv_igemm_kernel|convt_igemm_kernel|conv_out_mma_kernel|conv_quad_kernel|"
              r"convt_relu_kernel)\b")
WGRAD = r"\bwgrad_kernel\b"
