"""File loaders and the trainers' sample streams and batchers
(``voicepuppet_tpu.data`` counterpart)."""

from voicepuppet_torch.data.loaders import (load_text_array, load_image,
                                            load_landmarks)
from voicepuppet_torch.data.generators import (ArraySource, FileSource,
                                               BFMNetBatcher,
                                               PixReferBatcher,
                                               ear_compute, split_silence)

__all__ = ["load_text_array", "load_image", "load_landmarks",
           "ArraySource", "FileSource", "BFMNetBatcher", "PixReferBatcher",
           "ear_compute", "split_silence"]
