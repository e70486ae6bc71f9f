"""voicepuppet_torch — the PyTorch/CUDA port of voicepuppet_tpu.

The JAX package (``voicepuppet_tpu``) is the reference; this package keeps
its module names and public layouts (NHWC images, ``[B,V,3]`` vertices,
``[F,3]`` triangles, ``[T,257]`` coefficients) so every module can be held
against its counterpart.  It imports ``torch`` and never ``jax``, ``flax``
or anything of ``voicepuppet_tpu``: what it needs of the numpy-only
modules there it keeps as its own copies.

Layer map of the serving path (``pipeline.synthesize.Synthesizer``) and
the trainers (``train``):

  config        dataclasses + YAML loader (serving and training)
  audio         log-mel frontend as fp32 matmuls
  models        BFMNet (audio -> expression coeffs) and its loss, PixRefer
                generator and discriminator, the VGG-16 perceptual trunk
  data          file loaders, sample streams and batchers for training
  face3d        BFM asset, 3DMM decode, plain z-buffer raster + its spec
  ops           raster dispatch and the hand-written CUDA raster kernel
  pipeline      coeff program, chunked frame program, YUV/rgb8 drain, CLI,
                streaming, R-Net identity path, landmarks, mesh video
  tools         TF checkpoint/GraphDef readers, TF name maps, lm3d
  train         BFMNet and PixRefer trainers, optimizer, train states,
                checkpoints, metrics and profiler hook
  utils         video writing, event files, the BFMNet eval grid (K1)
  weights       JAX parameter trees <-> this package's state_dicts

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
