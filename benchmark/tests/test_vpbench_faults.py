"""The comparison that decides ``correct`` fails a broken system.  Each
test skips the harness's look for a card, breaks the timed path
underneath, drives the rest of a run at test size on the CPU, and sees
``correct`` come out false, once for each fault the cell can have: a
step that returns its state unchanged, half of the batch left out with
the mean taken over the rest, an answer altered where it is produced.
(Every cell runs on one chip: there is no exchange between chips to
leave out.)"""

import contextlib
import time

import pytest
import torch

from benchmark import harness
from benchmark.control import half_batch
from benchmark.run import run_cell


def _run(cell, seconds):
    return run_cell(harness.Run(cell, 2 ** 31 + 33, seconds, False, "cpu",
                                time.perf_counter()))


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def altered_frame():
    """The drain hands back one frame of each chunk inverted."""
    from voicepuppet_torch.pipeline.synthesize import Synthesizer
    original = Synthesizer.fetch_frames

    def fetch(self, packed, n):
        out = original(self, packed, n).copy()
        out[n // 2] = 255 - out[n // 2]
        return out

    with patched(Synthesizer, "fetch_frames", fetch):
        yield


@contextlib.contextmanager
def half_moments():
    """G's batch norm takes its moments over the first half of the chunk
    and normalizes the whole chunk with them."""
    from voicepuppet_torch.models.pixrefer import StatelessBatchNorm

    def forward(self, x):
        xf = x.float()
        h = xf[:max(1, xf.shape[0] // 2)]
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        mean2 = torch.square(h).mean(dim=(0, 2, 3), keepdim=True)
        return self.normalize(xf, mean, mean2).to(x.dtype)

    with patched(StatelessBatchNorm, "forward", forward):
        yield


@contextlib.contextmanager
def stale_stream_state():
    """The streamed GRU starts every block from zero: the carried state is
    dropped."""
    from voicepuppet_torch.models.bfmnet import BFMNet
    original = BFMNet.decode

    def decode(self, x, ears, seq_len, rnn_state=None, **kw):
        return original(self, x, ears, seq_len, rnn_state=None, **kw)

    with patched(BFMNet, "decode", decode):
        yield


@contextlib.contextmanager
def unchanged_state():
    """The optimizers' steps leave the parameters where they were."""
    from voicepuppet_torch.train.optim import ReferenceAdam
    with patched(ReferenceAdam, "step", lambda self, closure=None: None):
        yield


SERVE_FAULTS = {"answer altered": altered_frame,
                "half the batch's moments": half_moments}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_batch_clips_fault_is_not_correct(tiny, fault):
    with SERVE_FAULTS[fault]():
        out = _run(tiny("serve-batch-clips"), 0.5)
    assert not harness.judged(out.checks), out.checks


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS) + ["state dropped"])
def test_stream_fault_is_not_correct(tiny, fault):
    faults = dict(SERVE_FAULTS, **{"state dropped": stale_stream_state})
    with faults[fault]():
        out = _run(tiny("serve-stream-live"), 3.5)
    assert not harness.judged(out.checks), out.checks


@pytest.mark.parametrize("fault", ["state unchanged", "half batch"])
def test_train_fault_is_not_correct(tiny, fault):
    ctx = unchanged_state if fault == "state unchanged" else half_batch
    with ctx():
        out = _run(tiny("train-pixrefer512-b2"), 0.5)
    assert not harness.judged(out.checks), out.checks

