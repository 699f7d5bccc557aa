"""svgir_tpu_torch: the SVG-IR surfel rasterizer, the stage-1 trainer and
the stage-2 (deferred-PBR) step and eval render in PyTorch, with their
binning, blend and env-map lookup kernels written in CUDA C++ for Hopper
(``csrc/``, bound through ``kernels/``).

The package mirrors the layout of ``svgir_tpu`` and is held to it by the
``tests/test_torch_*.py`` parity tests.  It imports neither JAX nor
``svgir_tpu``.

Entry points (``init_from_points``, ``make_camera``/``look_at_camera``,
``make_train_step``, ``train_stage1``, ``direct_light_map_init``,
``make_svgss_train_step``, ``train_stage2``) put their tensors on ``cuda``
unless the caller passes ``device="cpu"``.
"""

import torch

# The compositing math and the SSIM blur run in full float32: TF32 keeps
# about three decimal digits, which corrupts the exponentiated
# transmittance chain.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
