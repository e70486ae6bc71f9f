"""The raster A/B profile entry points, counterparts of the JAX package's
``experiments/profile_raster*.py``.  Each module does nothing when
imported; run one with ``python -m voicepuppet_torch.experiments.<name>``
(on the card unless ``--device cpu`` is given)."""
