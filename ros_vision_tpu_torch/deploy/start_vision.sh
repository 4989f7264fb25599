#!/usr/bin/env bash
# Launch the vision system on the PyTorch/CUDA port (start_vision.bsh
# equivalent; the port's counterpart of scripts/start_vision.sh). The
# kernels build under build/ of the checkout at first use.
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m ros_vision_tpu_torch.launch "$@"
