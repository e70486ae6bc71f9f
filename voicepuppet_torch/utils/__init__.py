"""Plots, the BFMNet eval grid and video writing
(``voicepuppet_tpu.utils`` counterpart)."""

from voicepuppet_torch.utils.viz import (plot_bfm_coeff_seq, plot_lmk_seq,
                                         plot_image_seq)
from voicepuppet_torch.utils.video import save_image_seq_video

__all__ = ["plot_bfm_coeff_seq", "plot_lmk_seq", "plot_image_seq",
           "save_image_seq_video"]
