"""maskunet-tpu's PyTorch port, for NVIDIA Hopper (H100).

A second package beside `maskunet_tpu` (the JAX reference), laid out the
same way so each module's counterpart sits at the same path:

  core/     layers and initializers as plain functions on tensors, the
            training state, the device choice
  ops/      masked attention, the flash glue, the hand-written CUDA
            kernels it launches (csrc/, built with nvcc on first use),
            segmentation metrics
  models/   MaskAttn-UNet: init, apply (eval and train), BN folding, bf16
            cast
  losses/   cross-entropy
  train/    the train and eval steps, the optimizer and state set-up
  utils/    weights handed over from the JAX package's numpy trees
  tasks/    the recipe table
  tools/    A/B of kernel variants on the card
  serve.py  the micro-batching HTTP server

It imports torch and numpy, never jax or anything of `maskunet_tpu`.
The serving path and the training step are ported; the training loop,
checkpoints and datasets come next.
"""
