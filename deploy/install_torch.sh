#!/bin/bash
# Install the PyTorch + CUDA port of the X-engine on a host (the reference
# `deploy` script analog).  Run from the repo root.
#
# Roles:
#   - gpu hosts: the package, the port's native capture library and CUDA
#     kernels prebuilt (so a unit's first start does not build them), the
#     systemd units and their environment files
#   - control hosts: the python package only (control/monitoring clients)
#
# ETCD_HOST (default 127.0.0.1) goes into the environment files; pipeline
# i runs on card i / 2, as the reference's 4 pipelines on 2 cards a server.
set -euo pipefail

ROLE="${1:-gpu}"            # gpu | control
PREFIX="${PREFIX:-$HOME/.local}"
ETCD_HOST="${ETCD_HOST:-127.0.0.1}"
NPIPELINE="${NPIPELINE:-4}"
LOG=~/deploy_cbd_torch_$(date --iso-8601=seconds).log

echo "installing role=$ROLE prefix=$PREFIX" | tee -a "$LOG"

python -m pip install -e . 2>&1 | tee -a "$LOG"

if [[ "$ROLE" == "gpu" ]]; then
    # both into caltech_bifrost_dsp_tpu_torch/_build/, which .gitignore
    # lists; the kernels need nvcc and a card
    python -c "from caltech_bifrost_dsp_tpu_torch.io import native; \
print('native library', native.build())" 2>&1 | tee -a "$LOG"
    python -c "from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build; \
print('kernels', _build.library()._name)" 2>&1 | tee -a "$LOG"
    conf="$HOME/.config/cbd-torch"
    mkdir -p "$conf" "$HOME/.config/systemd/user"
    for ((i = 0; i < NPIPELINE; i++)); do
        env="$conf/pipeline-$i.env"
        if [[ ! -e "$env" ]]; then
            printf 'CUDA_VISIBLE_DEVICES=%d\nETCD_HOST=%s\n' \
                "$((i / 2))" "$ETCD_HOST" > "$env"
        fi
    done
    if [[ ! -e "$conf/manager.env" ]]; then
        printf 'ETCD_HOST=%s\n' "$ETCD_HOST" > "$conf/manager.env"
    fi
    cp deploy/cbd-torch-pipeline@.service \
       deploy/cbd-torch-xeng-manager.service \
       "$HOME/.config/systemd/user/" 2>&1 | tee -a "$LOG"
    systemctl --user daemon-reload || true
    echo "enable with: systemctl --user enable --now" \
         "cbd-torch-xeng-manager cbd-torch-pipeline@0" | tee -a "$LOG"
fi

echo "done" | tee -a "$LOG"
