"""voicepuppet_torch — the PyTorch/CUDA port of voicepuppet_tpu.

The JAX package (``voicepuppet_tpu``) is the reference; this package keeps
its module names and public layouts (NHWC images, ``[B,V,3]`` vertices,
``[F,3]`` triangles, ``[T,257]`` coefficients) so every module can be held
against its counterpart.  It imports ``torch`` and never ``jax``, ``flax``
or anything of ``voicepuppet_tpu``: what it needs of the numpy-only
modules there it keeps as its own copies.

Layer map of the serving path (``pipeline.synthesize.Synthesizer``):

  config        dataclasses + YAML loader (serving subset)
  audio         log-mel frontend as fp32 matmuls
  models        BFMNet (audio -> expression coeffs), PixRefer generator
  face3d        BFM asset, 3DMM decode, plain z-buffer raster + its spec
  ops           raster dispatch and the hand-written CUDA raster kernel
  pipeline      coeff program, chunked frame program, YUV/rgb8 drain, CLI,
                streaming, R-Net identity path, landmarks, mesh video
  tools         TF checkpoint/GraphDef readers, TF name maps, lm3d
  utils         video writing
  weights       JAX parameter trees -> this package's state_dicts

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
