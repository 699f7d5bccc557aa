#!/bin/bash
# Synthetic4Relight recipe on the PyTorch/CUDA port: the commands of
# script/run_syn4.sh, flag for flag, each root script replaced by its
# twin under svgir_tpu_torch/cli.  Run from the repository root; the
# datasets it names are not in the repository: point the variables
# at them.
set -e

root_dir="${SYN4_ROOT:-datasets/Synthetic4Relight/}"
list="${SCENES:-jugs hotdog chair air_baloons}"

for i in $list
do
    python -m svgir_tpu_torch.cli.train --eval \
        -s ${root_dir}${i} \
        -m output/Syn4Relight/${i}/gss \
        --lambda_normal_render_depth 0.001 \
        --lambda_normal_smooth 0.02 \
        --lambda_mask_entropy 0.1 \
        --save_training_vis \
        --densify_grad_normal_threshold 1e-8 \
        --lambda_depth_var 1e-2

    python -m svgir_tpu_torch.cli.train --eval \
        -s ${root_dir}${i} \
        -m output/Syn4Relight/${i}/render_relight \
        -c output/Syn4Relight/${i}/gss/chkpnt30000.npz \
        --save_training_vis \
        --position_lr_init 0.0 \
        --position_lr_final 0.0 \
        --normal_lr 0.001 \
        --sh_lr 0.0 \
        --opacity_lr 0.005 \
        --scaling_lr 0.0005 \
        --rotation_lr 0.0001 \
        --iterations 50000 \
        --lambda_base_color_smooth 1.0 \
        --lambda_roughness_smooth 0.5 \
        --lambda_light_smooth 1 \
        --lambda_light 0.02 \
        -t render_relight --sample_num 64 \
        --save_training_vis_iteration 200 \
        --lambda_env_smooth 0.02

    python -m svgir_tpu_torch.cli.eval_relighting \
        -s ${root_dir}${i} \
        -m "output/Syn4Relight/${i}/render_relight" \
        -c "output/Syn4Relight/${i}/render_relight/chkpnt50000.npz" \
        --hdr ${root_dir}/env/envmap3.exr ${root_dir}/env/envmap6.exr \
              ${root_dir}/env/envmap12.exr \
        --sample_num 256
done
