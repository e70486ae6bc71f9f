"""Online (chunked) synthesis: feed pcm as it arrives, get video frames
back with bounded latency — the serving shape of a live microphone.

Port of ``voicepuppet_tpu/pipeline/streaming.py``:

  * The GRU is exactly streamable: run chunk by chunk with the carried
    hidden state (``BFMNet.decode(rnn_state=...)``), it reproduces the
    whole-clip recurrence bit for bit on the same encoder inputs.
  * The convolutional trunk is streamed with overlap: each step encodes a
    zero-padded window of ``ctx_left + chunk + ctx_right`` frames and keeps
    the middle ``chunk``, so interior frames see their whole receptive
    field; the first chunk sees mel-of-silence where the batch path sees
    'SAME' padding (the start-of-stream approximation).
  * Latency is ``ctx_right`` frames of lookahead plus one chunk.

Frames are rendered by the batch ``Synthesizer``'s frame program, with its
raster (``raster_group`` > 0: the grouped kernel K4) and its bf16
generator, one full chunk per block (a short last block is padded to the
chunk with zero coefficients).  Over a sharded Synthesizer (``mesh=``)
every rank feeds the same pcm and each block goes through the sharded
frame program (``mesh_partition="spatial"``, the low-latency mode, or
``"frames"``: the chunk is already a multiple of the world size); rank 0
gets the blocks and the other ranks empty lists.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from voicepuppet_torch.pipeline.align import head_sway_angles
from voicepuppet_torch.pipeline.synthesize import (Identity, Synthesizer,
                                                   splice_coeff_sequence)
from voicepuppet_torch.utils import tracing


class StreamingCoeffPredictor:
    """pcm chunks in -> expression-coefficient chunks out.

    Keeps the GRU hidden state across chunks and the pcm lookback and
    lookahead the conv trunk needs.  Blocks are [emit, 64] tensors on the
    synthesizer's device.  ``request``: the stream's id in its spans."""

    def __init__(self, synth: Synthesizer, chunk: int = 16,
                 ctx_left: int = 24, ctx_right: int = 12,
                 rng_seed: int = 0):
        self.synth = synth
        self.chunk = chunk
        self.ctx_left = ctx_left
        self.ctx_right = ctx_right
        cfg = synth.cfg
        self._scale = cfg.frame_mfcc_scale           # 5 mel rows / frame
        self._hop = cfg.mel.hop_step
        self._fps_samples = cfg.frame_wav_scale      # 640 pcm / frame
        w_frames = ctx_left + chunk + ctx_right
        # pcm span covering the window's mel rows (generator.py:478)
        self._pcm_len = (self._hop * (w_frames * self._scale - 1)
                         + cfg.mel.win_length)
        self._buffer = np.zeros((0,), np.float32)
        self._buffer_start = 0        # absolute sample index of buffer[0]
        self._next_frame = 0          # next frame to emit
        self._rng = np.random.RandomState(rng_seed)
        self._state = None
        self._done = False
        self.request = tracing.new_request()

    @property
    def frames_buffered(self) -> int:
        """Frames of audio received but not yet emitted."""
        total = ((self._buffer_start + self._buffer.shape[0])
                 // self._fps_samples)
        return max(0, total - self._next_frame)

    def feed(self, pcm: np.ndarray) -> List[torch.Tensor]:
        """Append pcm; return the [chunk, 64] coefficient blocks that became
        computable (each needs ``ctx_right`` frames of lookahead)."""
        if self._done:
            raise RuntimeError(
                "feed() after flush(): the GRU state was finalized on a "
                "partial last chunk — start a new StreamingCoeffPredictor")
        self._buffer = np.concatenate(
            [self._buffer, np.asarray(pcm, np.float32)])
        out = []
        while True:
            block = self._try_step(flush=False)
            if block is None:
                self._trim_buffer()
                return out
            out.append(block)

    def _trim_buffer(self):
        """Drop the pcm no future window reads (left of ``next_frame -
        ctx_left``): a live stream would otherwise keep its whole
        history."""
        keep_abs = max(0, (self._next_frame - self.ctx_left)
                       * self._scale * self._hop)
        drop = keep_abs - self._buffer_start
        if drop > 0:
            self._buffer = self._buffer[drop:]
            self._buffer_start = keep_abs

    def flush(self) -> List[torch.Tensor]:
        """End of stream: zero-pad the lookahead and emit the tail (a short
        last block trimmed to the frames actually fed)."""
        self._done = True
        out = []
        while True:
            block = self._try_step(flush=True)
            if block is None:
                return out
            out.append(block)

    @torch.inference_mode()
    def _try_step(self, flush: bool) -> Optional[torch.Tensor]:
        s = self._next_frame
        total_samples = self._buffer_start + self._buffer.shape[0]
        avail = total_samples // self._fps_samples - s
        if avail <= 0:
            return None
        if not flush and avail < self.chunk + self.ctx_right:
            return None
        emit = min(self.chunk, avail)

        # pcm of frames [s - ctx_left, s + chunk + ctx_right), zero-padded
        # at the stream's edges; sample indices are absolute and the buffer
        # holds [_buffer_start, total_samples)
        start_sample = (s - self.ctx_left) * self._scale * self._hop
        window = np.zeros((self._pcm_len,), np.float32)
        lo = max(self._buffer_start, start_sample)
        hi = min(total_samples, start_sample + self._pcm_len)
        if hi > lo:
            window[lo - start_sample:hi - start_sample] = \
                self._buffer[lo - self._buffer_start:hi - self._buffer_start]

        # the inference ear signal: random sub-0.01 (infer_bfmvid.py:182)
        ears = self._rng.rand(1, self.chunk, 1).astype(np.float32) / 100.0
        synth = self.synth
        dev = synth.device
        with tracing.span("vp.stream.coeff", request=self.request,
                          size=emit, device=dev):
            mel = synth.frontend(torch.as_tensor(window[None], device=dev))
            enc = synth.bfmnet.encode(mel)
            mid = enc[:, self.ctx_left:self.ctx_left + self.chunk]
            exp, state = synth.bfmnet.decode(
                mid, torch.as_tensor(ears, device=dev),
                torch.full((1,), self.chunk, dtype=torch.int64, device=dev),
                rnn_state=self._state, return_rnn_state=True)
        # carry the recurrence only after a full chunk: the state must be
        # the one after the frames actually emitted
        self._state = state if emit == self.chunk else None
        if emit < self.chunk:
            self._done = True
        self._next_frame = s + emit
        return exp[0, :emit]


class StreamingSynthesizer:
    """pcm chunks in -> rendered [chunk, S, S, 3] uint8 frame blocks out.

    Each block runs the batch Synthesizer's frame program (3DMM decode ->
    raster -> PixRefer G -> composite -> YUV pack), so per-block work is
    the batch path's.  Block k+1 is dispatched before block k is drained,
    so the card computes one while the host unpacks the other.  A PixFlow
    Synthesizer is refused."""

    def __init__(self, synth: Synthesizer, identity: Identity,
                 face3d_ref: np.ndarray, fg_ref: np.ndarray,
                 background: Optional[np.ndarray] = None,
                 ctx_left: int = 24, ctx_right: int = 12):
        if not synth.program.live:
            raise NotImplementedError(
                f"streaming a {synth.cfg.generator!r} Synthesizer is not "
                f"supported: only PixRefer is served live")
        self.synth = synth
        self.identity = identity
        s = synth.img_size
        dev = synth.device
        self.coeffs = StreamingCoeffPredictor(synth, chunk=synth.chunk,
                                              ctx_left=ctx_left,
                                              ctx_right=ctx_right)
        # the carried idle-sway walk continues the batch driver's sequence
        # across blocks (align.head_sway_angles state form)
        self._sway_state = (np.zeros(3, np.float64), 0.005)
        self._face3d_ref = torch.as_tensor(np.asarray(face3d_ref, np.float32),
                                           device=dev)
        self._fg_ref = torch.as_tensor(np.asarray(fg_ref, np.float32),
                                       device=dev)
        bg = np.zeros((s, s, 3)) if background is None else background
        self._bg_pool = torch.as_tensor(
            np.asarray(bg, np.float32).reshape(-1, s, s, 3), device=dev)
        self._program = synth.frame_program_for(identity)
        # frames emitted so far: the background pool cycles per frame
        # across blocks, as the batch driver's arange(T) % pool
        self._frames_emitted = 0

    def _dispatch(self, exp_block: torch.Tensor):
        """Splice, pad to the chunk and launch one block; returns its
        pending fetch and frame count without waiting for the card."""
        synth = self.synth
        dev = synth.device
        emit = int(exp_block.shape[0])
        c = synth.chunk
        coeff = torch.zeros((c, 257), device=dev)
        coeff[:emit] = splice_coeff_sequence(self.identity.bfmcoeff,
                                             exp_block[None])
        angles, self._sway_state = head_sway_angles(emit,
                                                    state=self._sway_state)
        ang = torch.zeros((c, 3), device=dev)
        ang[:emit] = torch.as_tensor(angles, device=dev)
        idx = torch.zeros((c,), dtype=torch.int64, device=dev)
        idx[:emit] = (self._frames_emitted + torch.arange(emit, device=dev)
                      ) % self._bg_pool.shape[0]
        self._frames_emitted += emit
        out = self._program(coeff, ang, self._bg_pool, idx, self._face3d_ref,
                            self._fg_ref)
        if out is None:         # a rank other than 0 of a sharded synth
            return None
        return synth.start_fetch(out), emit

    @torch.inference_mode()
    def _pipeline(self, blocks) -> List[np.ndarray]:
        outs: List[np.ndarray] = []
        pending = None
        stream = self.coeffs.request
        for block in blocks:
            with tracing.span("vp.stream.block", request=stream,
                              size=int(block.shape[0]),
                              device=self.synth.device):
                cur = self._dispatch(block)
            if cur is None:
                continue
            if pending is not None:
                outs.append(self.synth.finish_fetch(*pending,
                                                    request=stream))
            pending = cur
        if pending is not None:
            outs.append(self.synth.finish_fetch(*pending, request=stream))
        return outs

    def feed(self, pcm: np.ndarray) -> List[np.ndarray]:
        """pcm chunk in -> list of [chunk, S, S, 3] uint8 frame blocks."""
        return self._pipeline(self.coeffs.feed(pcm))

    def flush(self) -> List[np.ndarray]:
        """End of stream: the remaining blocks, the last one trimmed."""
        return self._pipeline(self.coeffs.flush())
