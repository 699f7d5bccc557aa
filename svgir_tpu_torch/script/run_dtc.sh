#!/bin/bash
# DTC (rendered_data) recipe on the PyTorch/CUDA port: the commands of
# script/run_dtc.sh, flag for flag, each root script replaced by its
# twin under svgir_tpu_torch/cli.  Run from the repository root; the
# datasets it names are not in the repository: point the variables
# at them.
set -e

root_dir="${DTC_ROOT:-datasets/dtc/rendered_data/}"
list="${SCENES:-birdhouse bathroom Gargoyle Mallard airplane block}"

for i in $list
do
    python -m svgir_tpu_torch.cli.train --eval \
        -s ${root_dir}${i} \
        -m output/dtc/${i}/gss \
        --lambda_normal_render_depth 0.0 \
        --lambda_normal_smooth 0.02 \
        --lambda_mask_entropy 0.1 \
        --save_training_vis \
        --densify_grad_normal_threshold 1e-8 \
        --lambda_depth_var 1e-2

    python -m svgir_tpu_torch.cli.train --eval \
        -s ${root_dir}${i} \
        -m output/dtc/${i}/render_relight \
        -c output/dtc/${i}/gss/chkpnt30000.npz \
        --save_training_vis \
        --position_lr_init 0.0 \
        --position_lr_final 0.0 \
        --normal_lr 0.001 \
        --sh_lr 0.00025 \
        --opacity_lr 0.005 \
        --scaling_lr 0.0 \
        --rotation_lr 0.0 \
        --iterations 50000 \
        --lambda_base_color_smooth 0.005 \
        --lambda_roughness_smooth 0.005 \
        --lambda_light_smooth 0.0 \
        --lambda_light 0.0 \
        -t render_relight --sample_num 32 \
        --save_training_vis_iteration 200 \
        --lambda_env_smooth 0.02 \
        --env_resolution 32

    python -m svgir_tpu_torch.cli.eval_nvs --eval \
        -m "output/dtc/${i}/render_relight" \
        -c "output/dtc/${i}/render_relight/chkpnt50000.npz" \
        -t render_relight

    # as in script/run_dtc.sh: without the --hdr that eval_relighting
    # requires (both packages' parsers refuse it); add the DTC lights
    python -m svgir_tpu_torch.cli.eval_relighting \
        -s ${root_dir}${i} \
        -m "output/dtc/${i}/render_relight" \
        -c "output/dtc/${i}/render_relight/chkpnt50000.npz" \
        --sample_num 200
done
