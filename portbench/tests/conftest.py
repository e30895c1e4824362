"""Small CPU versions of the cells, for the harness's own tests."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import common  # noqa: E402


class Args:
    def __init__(self, workload, seed, seconds, trace):
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace


def small_refine():
    """refine_b4's files at a size the CPU runs in seconds: an 8 x 64
    decoder on a 16^3 grid, 3 iterations, 2 frames of 4 cars."""
    bench, cell, config, traffic = common.load_cell("refine_b4")
    config = copy.deepcopy(config)
    config["NetworkSpecs"]["dims"] = [64] * 8
    config["refine"].update(grid_density=16, iters=3, warm_refresh=2)
    traffic = dict(traffic, frames=2, check_frames=2,
                   trace_units=2)
    return bench, cell, config, traffic


def small_dsdf():
    """dsdf_train_b64's files at a CPU size: an 8 x 32 decoder, 8 scenes
    of 2000 rows, 4 scenes x 256 rows a step."""
    bench, cell, config, traffic = common.load_cell("dsdf_train_b64")
    config = copy.deepcopy(config)
    config["NetworkSpecs"]["dims"] = [32] * 8
    config.update(SamplesPerScene=256, ScenesPerBatch=4)
    traffic = dict(traffic, scenes=8, rows_per_scene=2000)
    return bench, cell, config, traffic


@pytest.fixture
def refine_files():
    return small_refine()


@pytest.fixture
def dsdf_files():
    return small_dsdf()


def small_css():
    """css_train_b13's files at a CPU size: width 8, a database of 26
    crops (2 whole batches of 13)."""
    bench, cell, config, traffic = common.load_cell("css_train_b13")
    config = dict(config, width=8)
    traffic = dict(traffic, crops=26, check_steps=2, trace_units=2)
    return bench, cell, config, traffic


@pytest.fixture
def css_files():
    return small_css()
