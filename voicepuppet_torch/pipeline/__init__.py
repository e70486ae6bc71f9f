"""The serving path (``voicepuppet_tpu.pipeline`` counterpart)."""

from voicepuppet_torch.pipeline.synthesize import (Synthesizer,
                                                   SynthesisAssets)

__all__ = ["Synthesizer", "SynthesisAssets"]
