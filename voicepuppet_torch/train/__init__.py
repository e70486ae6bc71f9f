"""Training: the BFMNet, PixRefer, PixFlow, ATNet and VGNet trainers on
one device, their optimizer, loop, train states, checkpoints and logs
(port of ``voicepuppet_tpu/train``)."""
