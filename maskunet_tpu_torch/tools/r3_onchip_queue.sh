#!/bin/bash
# The port's pending card measurements as one queue. Each step is bounded
# on its own, so one failing phase does not lose the rest. Results land in
# $RESULTS (default: runs/queue under the repo root), one file a step. Counterpart of tools/r3_onchip_queue.sh; until the port has a
# bench of its own, the JAX queue's bench.py step is mfu_report, which
# gives the serving and train-step img/s.
#
#   bash maskunet_tpu_torch/tools/r3_onchip_queue.sh
set -x
cd "$(dirname "$0")/../.." || exit 1
RESULTS=${RESULTS:-runs/queue}
mkdir -p "$RESULTS"
export PYTHONPATH=.${PYTHONPATH:+:$PYTHONPATH}

# 0. liveness gate: a matmul on the card
timeout 120 python -c "
import torch
x = torch.ones(256, 256, device='cuda')
print(float((x @ x).sum()), torch.cuda.get_device_name(0))
" || { echo CARD_NOT_AVAILABLE; exit 1; }

# 1. serving and training headline numbers (img/s, device ms, MFU)
timeout 900 python -m maskunet_tpu_torch.tools.mfu_report 8 \
  | tee "$RESULTS/mfu_report.txt"

# 2. int8 quantized inference A/B (is int8 a win once the activation
#    quantization and the dequant are paid?)
timeout 900 python -m maskunet_tpu_torch.tools.quant_ab 8 \
  | tee "$RESULTS/quant_ab.txt"

# 3. conv im2col-vs-direct in-model A/B
timeout 900 python -m maskunet_tpu_torch.tools.conv_model_ab \
  | tee "$RESULTS/conv_model_ab.txt"

# 4. kernel parity on the card (the built kernels against dense attention)
timeout 900 python -m maskunet_tpu_torch.tools.tpu_kernel_paritycheck \
  | tee "$RESULTS/parity.txt"

# 5. precomputed-compaction-plan A/B (the mask slot assignment hoisted
#    out of each forward and step)
timeout 900 python -m maskunet_tpu_torch.tools.plan_ab 8 30 \
  | tee "$RESULTS/plan_ab.txt"
