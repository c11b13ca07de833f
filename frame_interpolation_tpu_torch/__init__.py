"""PyTorch + CUDA port of the film_net frame interpolator.

The JAX package `frame_interpolation_tpu` beside it is the reference. This
package imports neither JAX nor that package. Its public functions keep the
JAX package's NHWC layout; on CUDA tensors the warp and the feature
extractor's conv stacks run hand-written Hopper kernels (csrc/), on CPU
tensors their plain PyTorch versions.
"""
