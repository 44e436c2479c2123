"""Spatial partitioning on a (2, 2) grid of gloo ranks on the CPU: two data
indices, each image on a spatial group of two. The checks and bounds of
`test_torch_spatial.py` (one spawn of the four ranks, module fixture), and
the pipelines of the two ranks of a spatial group yield identical batches
while the two data indices read different files.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_spatial import (  # noqa: E402
    check_backbone, check_bands, check_pipelines, check_steps, spawn_grid)
from test_torch_threads import one_thread  # noqa: E402,F401


DATA, SPATIAL = 2, 2


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return spawn_grid(tmp_path_factory, DATA, SPATIAL, with_executor=False)


def test_train_steps_match_one_process(grid):
    check_steps(grid[1], SPATIAL)


def test_drop_connect_backbone_matches_one_process(grid):
    check_backbone(grid[1], SPATIAL)


def test_bands_reassemble_the_batch(grid):
    check_bands(grid[1], SPATIAL)


def test_pipelines_of_a_spatial_group_agree(grid):
    check_pipelines(grid[1], SPATIAL)
