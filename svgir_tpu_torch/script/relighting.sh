#!/bin/bash
# Composition / trajectory relighting on the PyTorch/CUDA port: the commands of
# script/relighting.sh, flag for flag, each root script replaced by its
# twin under svgir_tpu_torch/cli.  Run from the repository root; the
# datasets it names are not in the repository: point the variables
# at them.
set -e

python -m svgir_tpu_torch.cli.relighting --config configs/teaser.json \
    --output output/relighting/teaser --hdr env_map/teaser.hdr \
    --sample_num 384

python -m svgir_tpu_torch.cli.relighting --config configs/nerf_syn.json \
    --output output/relighting/nerf_syn --hdr env_map/composition.hdr \
    --sample_num 384 --rotate_light
