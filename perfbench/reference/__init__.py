"""Plain PyTorch reference of MaskAttn-UNet: the model, its losses, the
triplet sampler and AdamW, in f32 (or with fp8-rounded operands, the
control). Imports nothing of the program under test."""
