"""maskunet-tpu's PyTorch port, for NVIDIA Hopper (H100).

A second package beside `maskunet_tpu` (the JAX reference), laid out the
same way so each module's counterpart sits at the same path:

  core/     layers and initializers as plain functions on tensors, the
            training state, the device choice, checkpoints in the JAX
            package's msgpack format, early stop, metrics logs
  data/     image I/O (cv2, imported where it decodes), the ADE20K, COCO
            and Cityscapes readers, the seeded synthetic dataset, subsets,
            the example cache, the batch iterator and the prefetcher to
            the card, the dataset downloads (stdlib; never run by a test)
  ops/      masked attention, the flash glue, the hand-written CUDA
            kernels it launches (csrc/, built with nvcc on first use),
            segmentation metrics
  models/   MaskAttn-UNet: init, apply (eval and train), BN folding, bf16
            cast, int8 quantization and its calibration
  losses/   cross-entropy, the instance-contrastive triplet loss
  train/    the train and eval steps (the loss blends of all four
            patterns), the optimizer and its lr schedules, the training
            loop and its validation
  evaluation/  RLE, connected-component instances, DBSCAN of the
            embeddings (PyTorch, on the card), COCO mask AP, PQ
  utils/    weights handed over from the JAX package's numpy trees, the
            reference's .pth state_dicts imported and exported, the
            profiler window, the NaN guard and the stall watchdog, the
            native mask ops (csrc/maskops.cpp, built with g++ on first
            use), the sample and prediction panels (matplotlib)
  tasks/    the recipe table, the datasets a recipe trains on, the
            semantic, instance and panoptic evaluators, prediction over a
            directory of images
  tools/    A/B of kernel variants on the card, the fake on-disk layouts,
            the nine recipes end to end, HTTP serving load and its
            breakdown, the 256 px configuration, the FLOPs account
  serve.py  the micro-batching HTTP server (live, int8, or from an
            exported artifact)
  export.py serving artifacts through `torch.export`, the flash kernels
            as the operators `maskunet::flash_fwd_nomax` / `_online`
  cli.py    the command line: recipes, train, evaluate, visualize,
            predict, export, import-torch

It imports torch and numpy, never jax or anything of `maskunet_tpu`.
Every module of the JAX package has its counterpart (the parallel axes
under `parallel/` too); of the repo's `tools/`, the ones named above.
"""
