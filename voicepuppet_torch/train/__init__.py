"""Training: the BFMNet and PixRefer trainers on one device, their
optimizer, train states, checkpoints and logs (port of
``voicepuppet_tpu/train``)."""
