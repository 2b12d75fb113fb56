"""PyTorch + CUDA port of kd_cheap_conv_tpu (DeepLab knowledge distillation
by cheap-conv replacement), beside the JAX package, which stays the
reference. Module names follow the JAX package's, so each counterpart is
found under the same path. This package imports torch and never JAX.
"""
