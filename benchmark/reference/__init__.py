"""The benchmark's plain reference: the stage-1 and stage-2 training steps
of SVG-IR in plain PyTorch float32, with TF32 off.

Frozen copies of the plain versions of ``svgir_tpu_torch`` (the semantics
of ``svgir_tpu``, which the repository's CPU tests hold them to): the
camera model, the surfel preprocess, the counting binner, the
image-layout blend and its backward, the losses, the env lookup, the
shading, the radiance consistency loss and Adam.  Nothing here launches a
hand-written kernel or imports the program, JAX or ``svgir_tpu``; the
training steps are in ``steps.py``.
"""
