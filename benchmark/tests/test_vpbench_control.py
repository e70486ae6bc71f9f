"""The lower-precision control fails each cell's comparison, on the card,
at the cell's own size, on three seeds: the reference put in the system's
place one precision below the configuration's (TF32 matmuls and convs,
and for serving G's convs on fp8 operands).  Skips without a card.

    python -m pytest benchmark/tests/test_vpbench_control.py -m card
"""

import pytest

from benchmark import control, harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _fails(cell, values: dict) -> bool:
    limits = cell.workload["limits"]
    return any(values[k] > limits[k] for k in limits if k in values)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["serve-batch-clips",
                                      "serve-stream-live"])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_is_not_correct(card, workload, seed):
    harness.fix_cache_dirs()
    cell = harness.load_cell(workload)
    assert _fails(cell, control.serve_control(cell, seed))


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_is_not_correct(card, seed):
    harness.fix_cache_dirs()
    cell = harness.load_cell("train-pixrefer512-b2")
    assert _fails(cell, control.train_control(cell, seed))
