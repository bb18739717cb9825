"""One module a model: what the benchmark builds and checks of it.

A configuration (`configs/<name>.json`) names its model under `model`.
`spec.model_module` turns that name into the module's: lowercased, each
run of characters other than letters and digits made `_`, so
`MaskAttn-UNet` is `models/maskattn_unet.py`. The module holds

- `FIXED`: the configuration's keys that its plain reference cannot vary,
  with their values (`model` among them). `spec.load_cell` refuses a
  configuration that states anything else;
- `training(cell, seed, device)`: for a `training` mix, a
  `harness.training.Built`: the port's train state and step, the seeded
  initial parameters, the pool's classes and the keys of it that the step
  takes, the FLOPs a call, the attention kernels' least times (`{}` where
  the model has none of those kernels), the launch counters to log, and
  the plain reference's checked steps.

A new model is new files only: `models/<module>.py`, its plain reference
(`reference/<module>.py` or a folder of that name; plain PyTorch in f32,
importing nothing of the program), `configs/<name>.json` stating its
`model` and `FIXED`, `workloads/<cell>.json`, and entries in
`BENCHMARK.json`. The loop (`harness/<kind>.py`), the comparison's
arithmetic (`harness/compare.py`) and the metric readers stay as they are.
"""
