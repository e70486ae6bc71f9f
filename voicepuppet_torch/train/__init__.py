"""Training: the BFMNet, PixRefer, PixFlow, ATNet and VGNet trainers, on
one device or data-parallel over a ``parallel.mesh.DataGroup``, their
optimizer, loop, train states, checkpoints and logs (port of
``voicepuppet_tpu/train``)."""
