"""maskunet-tpu's PyTorch port, for NVIDIA Hopper (H100).

A second package beside `maskunet_tpu` (the JAX reference), laid out the
same way so each module's counterpart sits at the same path:

  core/     layers and initializers as plain functions on tensors, the
            training state, the device choice, checkpoints in the JAX
            package's msgpack format, early stop, metrics logs
  data/     image I/O (cv2, imported where it decodes), the ADE20K, COCO
            and Cityscapes readers, the seeded synthetic dataset, subsets,
            the example cache, the batch iterator and the prefetcher to
            the card
  ops/      masked attention, the flash glue, the hand-written CUDA
            kernels it launches (csrc/, built with nvcc on first use),
            segmentation metrics
  models/   MaskAttn-UNet: init, apply (eval and train), BN folding, bf16
            cast
  losses/   cross-entropy, the instance-contrastive triplet loss
  train/    the train and eval steps (the loss blends of all four
            patterns), the optimizer and its lr schedules, the training
            loop and its validation
  evaluation/  RLE, connected-component instances, DBSCAN of the
            embeddings (PyTorch, on the card), COCO mask AP, PQ
  utils/    weights handed over from the JAX package's numpy trees, the
            profiler window, the NaN guard and the stall watchdog, the
            native mask ops (csrc/maskops.cpp, built with g++ on first
            use), the sample and prediction panels (matplotlib)
  tasks/    the recipe table, the datasets a recipe trains on, the
            semantic, instance and panoptic evaluators, prediction over a
            directory of images
  tools/    A/B of kernel variants on the card, the fake on-disk layouts,
            the nine recipes end to end
  serve.py  the micro-batching HTTP server

It imports torch and numpy, never jax or anything of `maskunet_tpu`.
The serving path, the training step and the training loop (with
checkpoints both ways), the loss blends, the evaluators, the dataset
readers and prediction are ported; export, int8, the CLI and the
parallel axes are not yet.
"""
