"""PixFlow training of the port (``PixFlowTrainer.train_step``) against
the benchmark's plain training reference (``benchmark/reference/
pixflow_train.py``) and its replay of the input pipeline
(``benchmark/reference/pixflow_data.py``), on the CPU at ngf and ndf 8,
64², batch 3, from the same seeded random weights and the same dropout
generator seed, as the ``train-pixflow512-b3`` cell compares them on the
card.

Three steps on each side: the twelve dropout masks of each step drawn
alike, and the cell's readings (the worst relative loss gap, the worst
leaf's gap of first-gradient norms and of change norms, each over the
larger of its and the median leaf's reference norm).  On the CPU both
sides run the same operations in the same order, so the readings are 0
(measured); they are held to 1e-5 (losses) and 1e-4 (norms), room for
another torch build's kernels and far under the cell's limits.  Then the
spans the cell's metrics read, and each fault the cell's limits must
catch, read as not correct at those limits.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from benchmark import control_pixflow_train, harness, system_pixflow_train
from benchmark.drivers import train as train_driver
from benchmark.drivers import train_pixflow as driver
from benchmark.reference import pixflow_data, pixflow_train
from benchmark.traffic import panels
from voicepuppet_torch.models import pixflow as pf
from voicepuppet_torch.utils import tracing

torch.set_num_threads(1)

SEED = 2 ** 31 + 91
NGF, S, B = 8, 64, 3
LOSS_REL, NORM_REL = 1e-5, 1e-4
CPU = torch.device("cpu")


def _cell():
    cell = harness.load_cell("train-pixflow512-b3")
    cfg = copy.deepcopy(cell.config)
    cfg["pixflow"].update(ngf=NGF, ndf=NGF, img_size=S)
    return cfg, cell.workload["limits"]


def _batches(n=driver.CHECKED):
    rng = np.random.default_rng([SEED, 5])
    return [(rng.random((B, S, S, 6), np.float32),
             rng.random((B, S, S, 6), np.float32),
             rng.random((B, S, S, 3), np.float32)) for _ in range(n)]


@contextlib.contextmanager
def _masks_recorded(module, masks):
    """``module.dropout`` appends each mask it draws (the generator's
    draw replayed from its state) to ``masks``."""
    original = module.dropout

    def dropout(x, rate, generator):
        state = generator.get_state()
        masks.append(torch.rand(x.shape, generator=generator,
                                device=x.device) < 1.0 - rate)
        generator.set_state(state)
        return original(x, rate, generator)

    module.dropout = dropout
    try:
        yield
    finally:
        module.dropout = original


def _system(cfg, batches, masks=None):
    """The port's three steps -> (losses, first gradient norms, change
    norms, the state)."""
    g_w, d_w = driver.make_weights(cfg, SEED, CPU)
    trainer, state = system_pixflow_train.trainer(cfg, g_w, d_w, CPU)
    feed = iter([tuple(torch.from_numpy(b) for b in batch)
                 for batch in batches])
    ctx = (_masks_recorded(pf, masks) if masks is not None
           else contextlib.nullcontext())
    with ctx:
        state, _fed, losses, g1, moved = driver.checked_steps(
            trainer, state, feed, driver.dropout_generator(SEED, CPU),
            cfg["pixflow"]["training"]["beta1"])
    return losses, g1, moved, state


def _reference(cfg, batches, masks=None):
    g_w, d_w = driver.make_weights(cfg, SEED, CPU)
    ref = pixflow_train.Trainer(cfg, g_w, d_w, CPU,
                                driver.dropout_seed(SEED))
    params = list(ref.gen.parameters()) + list(ref.disc.parameters())
    p0 = [t.detach().clone() for t in params]
    losses, grads = [], {}
    ctx = (_masks_recorded(pixflow_train, masks) if masks is not None
           else contextlib.nullcontext())
    with ctx:
        for k, b in enumerate(batches):
            losses.append(ref.step(b, grads if k == 0 else None))
    moved = train_driver._norms([t.detach() - t0
                                 for t, t0 in zip(params, p0)])
    return losses, grads, moved, ref


@pytest.fixture(scope="module")
def steps():
    cfg, limits = _cell()
    batches = _batches()
    sys_masks, ref_masks = [], []
    sys_out = _system(cfg, batches, sys_masks)
    ref_out = _reference(cfg, batches, ref_masks)
    got = train_driver.readings(*sys_out[:3], *ref_out[:3])
    return {"cfg": cfg, "limits": limits, "batches": batches,
            "system": sys_out, "reference": ref_out, "readings": got,
            "masks": (sys_masks, ref_masks)}


def test_leaves_line_up_by_name(steps):
    """The norms are compared leaf by leaf in parameter order: both sides
    list the same names in the same order."""
    state, ref = steps["system"][3], steps["reference"][3]
    for mine, theirs in ((state.gen, ref.gen), (state.disc, ref.disc)):
        assert ([n for n, _ in mine.named_parameters()]
                == [n for n, _ in theirs.named_parameters()])


def test_twelve_masks_a_step_drawn_alike(steps):
    mine, theirs = steps["masks"]
    assert len(mine) == len(theirs) == 12 * driver.CHECKED
    for a, b in zip(mine, theirs):
        assert a.shape == (B, NGF * 8, S // 16, S // 16)
        assert torch.equal(a, b)
    # each forward draws its own masks
    assert not torch.equal(mine[0], mine[6])


def test_losses_match_the_reference(steps):
    assert steps["readings"]["loss_gap"] <= LOSS_REL, steps["readings"]
    mine = np.asarray(steps["system"][0])
    assert np.isfinite(mine).all() and (mine > 0).all()


@pytest.mark.parametrize("reading", ["grad_gap", "change_gap"])
def test_norms_match_the_reference(steps, reading):
    assert steps["readings"][reading] <= NORM_REL, steps["readings"]


def test_diffnet_takes_both_gradient_paths(steps):
    """``diffnet``'s weights get gradients through both renders: its
    first conv's gradient is not what the current render's path alone
    gives (the third fault below)."""
    names = [n for n, _ in steps["system"][3].gen.named_parameters()]
    i = names.index("generator.diffnet.stem7.weight")
    assert steps["system"][1]["gen"][i] > 0
    assert steps["reference"][1]["gen"][i] == pytest.approx(
        steps["system"][1]["gen"][i], rel=NORM_REL)


@pytest.mark.parametrize("fault", sorted(control_pixflow_train.FAULTS))
def test_fault_is_not_correct_at_the_cells_limits(steps, fault):
    with control_pixflow_train.FAULTS[fault]():
        sys_out = _system(steps["cfg"], steps["batches"])
    got = train_driver.readings(*sys_out[:3], *steps["reference"][:3])
    checks = {k: {"value": v, "limit": steps["limits"][k]}
              for k, v in got.items()}
    assert not harness.judged(checks), checks


def test_step_records_the_cells_spans():
    cfg, _ = _cell()
    g_w, d_w = driver.make_weights(cfg, SEED, CPU)
    trainer, state = system_pixflow_train.trainer(cfg, g_w, d_w, CPU)
    batch = tuple(torch.from_numpy(b) for b in _batches(1)[0])
    with tracing.recording() as rec:
        trainer.train_step(state, batch,
                           generator=driver.dropout_generator(SEED, CPU))
    summary = rec.summary()
    names = [s["name"] for s in summary["spans"]]
    assert sorted(names) == sorted(system_pixflow_train.SPANS)
    by = {s["name"]: s for s in summary["spans"]}
    assert by["vp.train.g_const"]["parent"] == by["vp.train.d_half"]["id"]
    assert by["vp.train.g_half"]["parent"] is None
    assert by["vp.train.d_half"]["end_ns"] <= by["vp.train.g_half"][
        "start_ns"]
    # the probe that refuses a system without them passes
    system_pixflow_train.check_spans(CPU)


def test_probe_refuses_a_step_without_spans(monkeypatch):
    monkeypatch.setattr(tracing, "span", lambda *a, **k: tracing._OFF)
    with pytest.raises(SystemExit, match="vp.train.g_const"):
        system_pixflow_train.check_spans(CPU)


def test_data_replays_the_systems_batches(tmp_path):
    """``pixflow_data`` works out the batches of ``PixFlowBatcher`` again
    from the JPEG files and the worker's seed, byte for byte."""
    from voicepuppet_torch.data.generators import FileSource, PixFlowBatcher
    cfg, _ = _cell()
    p = cfg["pixflow"]
    lst = panels.write_panel_dataset(str(tmp_path), SEED, 2, 4, S)
    pcfg = system_pixflow_train.port_config(cfg, lst)
    seed = SEED * 4 + 1
    it = iter(PixFlowBatcher(pcfg, FileSource(lst, pcfg, load_images=True),
                             seed=seed))
    for j in range(3):
        got = next(it)
        want = pixflow_data.batch(lst, S, p["crop_ratio"], seed, j,
                                  p["batch_size"])
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
