"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root.  Tests marked ``card`` need an NVIDIA GPU and skip
without one (``python -m pytest benchmark/tests -m card`` on the card)."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return "cuda"


def tiny_cell(name: str):
    """A cell at CPU test size: ngf 8 at 256², a 24² face mesh, BFMNet at
    width 0.25, three short clips in chunks of 16, small training data."""
    from benchmark import harness
    cell = harness.load_cell(name)
    cfg, wl = copy.deepcopy(cell.config), copy.deepcopy(cell.workload)
    cfg["pixrefer"].update(ngf=8, img_size=256)
    if "pixrefer" in cfg and "ndf" in cfg["pixrefer"]:
        cfg["pixrefer"]["ndf"] = 8
    if "face_model" in cfg:
        cfg["face_model"]["grid"] = 24
        cfg["bfmnet"]["backbone_width_mult"] = 0.25
    if "clips" in wl:
        wl["clips"].update(count=3, min_frames=20, max_frames=60)
        wl["chunk"] = 16
    if "data" in wl:
        wl["data"].update(clips=2, frames=4)
    if "sessions" in wl:
        wl["sessions"] = 2
    return harness.Cell(cell.name, cell.entry, wl, cfg, cell.end_to_end,
                        cell.per_layer)


@pytest.fixture
def tiny():
    return tiny_cell
