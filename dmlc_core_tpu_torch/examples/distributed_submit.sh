#!/bin/bash
# Launch patterns for the port's submit (python -m
# dmlc_core_tpu_torch.tracker.submit takes dmlc-submit's arguments).
set -e
cd "$(dirname "$0")/../.."

# 2 local workers with rendezvous (each reads its shard of the data and
# trains on the card)
python -m dmlc_core_tpu_torch.tracker.submit --cluster local --num-workers 2 \
    --host-ip 127.0.0.1 \
    python -m dmlc_core_tpu_torch.examples.train_higgs /tmp/higgs_demo.libsvm

# what a TPU pod launch would run (printed, not executed):
python -m dmlc_core_tpu_torch.tracker.submit --cluster tpu-pod --num-workers 4 --dry-run \
    --tpu-name my-pod --tpu-zone us-central2-b \
    python -m dmlc_core_tpu_torch.examples.train_higgs gs://bucket/higgs.libsvm
