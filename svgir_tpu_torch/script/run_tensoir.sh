#!/bin/bash
# TensoIR two-stage recipe on the PyTorch/CUDA port: the commands of
# script/run_tensoir.sh, flag for flag, each root script replaced by its
# twin under svgir_tpu_torch/cli.  Run from the repository root; the
# datasets it names are not in the repository: point the variables
# at them.
set -e

root_dir="${TENSOIR_ROOT:-dataset/TensoIR/}"
list="${SCENES:-hotdog armadillo ficus lego}"

for i in $list
do
    python -m svgir_tpu_torch.cli.train --eval \
        -s ${root_dir}${i} \
        -m output/TensoIR/${i}/gss \
        --lambda_normal_render_depth 0.0 \
        --lambda_normal_smooth 0.02 \
        --lambda_mask_entropy 0.1 \
        --save_training_vis \
        --densify_grad_normal_threshold 1e-8 \
        --lambda_depth_var 1e-2

    python -m svgir_tpu_torch.cli.eval_nvs --eval \
        -s ${root_dir}${i} \
        -m output/TensoIR/${i}/gss \
        -c output/TensoIR/${i}/gss/chkpnt30000.npz

    python -m svgir_tpu_torch.cli.train --eval \
        -s ${root_dir}${i} \
        -m output/TensoIR/${i}/render_relight \
        -c output/TensoIR/${i}/gss/chkpnt30000.npz \
        --save_training_vis \
        --position_lr_init 0.0 \
        --position_lr_final 0.0 \
        --normal_lr 0.001 \
        --sh_lr 0.00025 \
        --opacity_lr 0.005 \
        --scaling_lr 0.0 \
        --rotation_lr 0.0 \
        --iterations 50000 \
        --lambda_base_color_smooth 0.1 \
        --lambda_roughness_smooth 0.05 \
        --lambda_light_smooth 0.0 \
        --lambda_light 0.0 \
        -t render_relight --sample_num 64 \
        --save_training_vis_iteration 200 \
        --lambda_env_smooth 0.02 \
        --env_resolution 32

    python -m svgir_tpu_torch.cli.eval_nvs --eval \
        -s ${root_dir}${i} \
        -m "output/TensoIR/${i}/render_relight" \
        -c "output/TensoIR/${i}/render_relight/chkpnt50000.npz" \
        -t render_relight \
        --skip_train

    # relighting under the TensoIR novel env maps (pass the dataset's HDRs)
    python -m svgir_tpu_torch.cli.eval_relighting \
        -s ${root_dir}${i} \
        -m "output/TensoIR/${i}/render_relight" \
        -c "output/TensoIR/${i}/render_relight/chkpnt50000.npz" \
        --hdr ${root_dir}/env/bridge.hdr ${root_dir}/env/city.hdr \
              ${root_dir}/env/fireplace.hdr ${root_dir}/env/forest.hdr \
              ${root_dir}/env/night.hdr \
        --sample_num 384
done
