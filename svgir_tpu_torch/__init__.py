"""svgir_tpu_torch: the SVG-IR surfel rasterizer (both binners, the
image-layout and the tile-major blend, and the dense oracle), the stage-1
trainer with densification, the radiance bake and the stage-2
(deferred-PBR) step and eval render in PyTorch, with their binning, blend,
env-map lookup, grid-march and column-copy kernels written in CUDA C++ for
Hopper (``csrc/``, bound through ``kernels/``); and the training CLI
(``python -m svgir_tpu_torch.cli.train``) with its scene readers,
checkpoints, camera staging and instance-cap probe; the evaluation and
viewing commands (``cli/``); and the parallel paths on
``torch.distributed`` (``parallel/``: view data parallelism, the sharded
bake and the Gaussian- and tile-row-sharded rasterizer).

The package mirrors the layout of ``svgir_tpu`` and is held to it by the
``tests/test_torch_*.py`` parity tests.  It imports neither JAX,
``svgir_tpu`` nor ``native``.

Entry points (``init_from_points``, ``make_camera``/``look_at_camera``,
``make_train_step``, ``train_stage1``, ``direct_light_map_init``,
``make_svgss_train_step``, ``train_stage2``, ``load_checkpoint``, the CLI's
``--device``) put their tensors on ``cuda`` unless the caller asks for
``cpu``.
"""

import torch

# The compositing math and the SSIM blur run in full float32: TF32 keeps
# about three decimal digits, which corrupts the exponentiated
# transmittance chain.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
